"""The port's decode stages (tpz_torch/kernels/inflate_pipeline.py) held
against the JAX package's: the plain symbol walk against the lane-parallel
_symbol_walk_vz, _materialize_fn against JAX's, and the host layout
against the arrays JAX's decode pipeline builds. The inputs come once from the
port's oracle scans of small streams (at most 3 entries each). Markers
and bytes are integers: the tolerance is exact equality.

JAX's decode pipeline calls tpz.oracle, whose library Tier-1 never builds; the
tests that run them point it at the library tpz_torch.oracle builds,
for that test only."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpz.oracle as joracle
from tpz.kernels import inflate_pipeline as jip
from tpz_torch import oracle
from tpz_torch.utils import corpus
from tpz_torch.codecs import deflate
from tpz_torch.kernels import inflate_pipeline as ip

WALK_KEYS = ("stream_words", "body_bit_local", "walk_out_len", "tab",
             "len_base", "len_extra", "dist_base", "dist_extra", "start_pos")
MAT_KEYS = ("stream_words", "btype", "c0_pos_l", "c0_len", "c1_pos_l",
            "out_len")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain decode stages run many tiny torch ops, for which intra-op
    threads only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def indexed_items():
    """Encoder-indexed streams: [dynamic, stored, 3000-byte last block]
    and one fixed-Huffman block."""
    datas = [corpus.repetitive(65536, seed=1) + corpus.random_bytes(
        65536, seed=2) + corpus.text(3000, seed=3), b"abcabcabcabc" * 20]
    items = [deflate.compress_indexed(d, device="cpu") for d in datas]
    return datas, items


@pytest.fixture(scope="module")
def segment_items():
    """A foreign zlib stream cut into 16 KiB-output segments: mid-block
    starts, split-match carries (start_pos > 0)."""
    data = corpus.text(40_000, seed=7)
    raw = zlib.compress(data, 6)[2:-4]
    idx = ip.index_stream(raw, seg_out=1 << 14)
    assert len(idx["out_lens"]) == 3 and (idx["carry_len"] > 0).any()
    return data, raw, idx


def _indexed_layout(items):
    scans = {i: oracle.inflate_scan_headers(s, eb)
             for i, (s, eb, _) in enumerate(items)}
    return ip._indexed_layout(items, list(scans), scans)


def _segmented_layout(raw, idx):
    scan = oracle.inflate_scan_segments(raw, idx["hdr_bits"],
                                        idx["seg_bits"], idx["end_bits"])
    return ip._segmented_layout([(raw, idx)], [0], {0: scan})


def _walk_both(L):
    want = np.asarray(jax.jit(jip._symbol_walk_vz)(
        *(jnp.asarray(L[k]) for k in WALK_KEYS)))
    got = ip.symbol_walk(*(torch.from_numpy(L[k]) for k in WALK_KEYS))
    return got.numpy(), want


def test_indexed_inputs_cover_block_types(indexed_items):
    _, items = indexed_items
    L = _indexed_layout(items)
    np.testing.assert_array_equal(L["btype"], [2, 0, 2, 1])
    np.testing.assert_array_equal(L["out_len"], [65536, 65536, 3000, 240])
    np.testing.assert_array_equal(L["walk_out_len"], [65536, 0, 3000, 240])


def test_symbol_walk_plain_matches_jax_indexed(indexed_items):
    got, want = _walk_both(_indexed_layout(indexed_items[1]))
    assert got.shape == (4, ip.BLOCK)
    np.testing.assert_array_equal(got, want)
    assert (got[0] >> 28 == ip._KIND_MATCH).any()


def test_symbol_walk_plain_matches_jax_segments(segment_items):
    _, raw, idx = segment_items
    L = _segmented_layout(raw, idx)
    assert (L["start_pos"] > 0).any()
    got, want = _walk_both(L)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[L["start_pos"] > 0, 0], 0)


def test_symbol_walk_plain_matches_jax_on_corrupt_stream(indexed_items):
    """Flipped stream bits: both walks abort or decode garbage in the same
    way, and neither reads outside its slice."""
    L = _indexed_layout(indexed_items[1])
    words = L["stream_words"].copy()
    u = words.view(np.uint32)
    rng = np.random.default_rng(5)
    for _ in range(40):
        u[0, int(rng.integers(10, 800))] ^= np.uint32(
            1 << int(rng.integers(0, 32)))
    got, want = _walk_both({**L, "stream_words": words})
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["indexed", "segmented"])
def test_materialize_matches_jax(indexed_items, segment_items, route):
    if route == "indexed":
        L = _indexed_layout(indexed_items[1])
        carry = None
    else:
        L = _segmented_layout(*segment_items[1:])
        carry = L["carry"]
    markers = np.array(jax.jit(jip._symbol_walk_vz)(
        *(jnp.asarray(L[k]) for k in WALK_KEYS)))
    want = np.asarray(jip._materialize_fn(
        jnp.asarray(markers), *(jnp.asarray(L[k]) for k in MAT_KEYS),
        carry=None if carry is None else jnp.asarray(carry)))
    got = ip._materialize_fn(
        torch.from_numpy(markers), *(torch.from_numpy(L[k]) for k in MAT_KEYS),
        carry=None if carry is None else torch.from_numpy(carry))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def jax_oracle(monkeypatch):
    """tpz.oracle loading the library tpz_torch.oracle builds."""
    path = oracle.build()
    monkeypatch.setattr(joracle, "_LIB", None)
    monkeypatch.setattr(joracle, "_find_lib", lambda: path)
    return joracle


def _capture(monkeypatch, name):
    seen = {}

    def fake(*args, **kw):
        seen["args"] = [np.asarray(a) for a in args]
        seen["kw"] = kw
        n = kw.get("out_p") or args[0].shape[0] * ip.BLOCK
        return jnp.zeros(n, jnp.uint8)

    monkeypatch.setattr(jip, name, fake)
    return seen


def test_indexed_layout_matches_jax_pipeline(jax_oracle, monkeypatch,
                                           indexed_items):
    _, items = indexed_items
    seen = _capture(monkeypatch, "_decode_fused")
    jip.decompress_many_indexed(items, interpret=True)
    L = _indexed_layout(items)
    names = ("stream_words", "body_bit_local", "walk_out_len", "tab",
             "len_base", "len_extra", "dist_base", "dist_extra", "btype",
             "c0_pos_l", "c0_len", "c1_pos_l", "out_len")
    for name, arr in zip(names, seen["args"]):
        np.testing.assert_array_equal(L[name], arr, err_msg=name)
    np.testing.assert_array_equal(L["start_pos"], 0)


def test_segmented_layout_matches_jax_pipeline(jax_oracle, monkeypatch,
                                             segment_items):
    """JAX pads the batch to a power of two of dead rows; the port does
    not, so its rows equal JAX's first NB rows and JAX's rest are 0."""
    _, raw, idx = segment_items
    seen = _capture(monkeypatch, "_decode_segmented")
    jip.decompress_many_segmented([(raw, idx)], interpret=True)
    L = _segmented_layout(raw, idx)
    names = ("stream_words", "body_bit_local", "walk_out_len", "tab",
             "len_base", "len_extra", "dist_base", "dist_extra", "btype",
             "c0_pos_l", "c0_len", "c1_pos_l", "out_len", "start_pos",
             "carry", "dense_off")
    nb = len(idx["out_lens"])
    for name, arr in zip(names, seen["args"]):
        mine = L[name]
        if name in ("len_base", "len_extra", "dist_base", "dist_extra"):
            np.testing.assert_array_equal(mine, arr, err_msg=name)
            continue
        np.testing.assert_array_equal(mine, arr[:nb], err_msg=name)
        if name != "dense_off":
            assert not arr[nb:].any(), name


def test_jax_pipeline_and_port_decode_the_same(jax_oracle, monkeypatch,
                                             indexed_items, segment_items):
    """JAX's whole pipelines (lane-parallel walk, doubling resolve, the
    interpreter) and the port's return the same bytes."""
    monkeypatch.setenv("TPZ_INFLATE_WALK", "vz")
    datas, items = indexed_items
    small = [items[1], deflate.compress_indexed(corpus.text(5000, seed=9),
                                                device="cpu")]
    want = jip.decompress_many_indexed(small, interpret=True)
    assert want[0] == datas[1]
    assert ip.decompress_many_indexed(small, "cpu") == want
    data, raw, idx = segment_items
    want = jip.decompress_many_segmented([(raw, idx)], interpret=True)
    assert want == [data]
    assert ip.decompress_many_segmented([(raw, idx)], "cpu") == want


def test_indexed_batch_decodes_every_block_type(indexed_items):
    datas, items = indexed_items
    before = ip.host_declines
    assert ip.decompress_many_indexed(items, "cpu") == datas
    assert ip.host_declines == before


def test_symbol_walk_rejects_unsupported_device():
    z = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ip.symbol_walk(z, *[z] * 8)
