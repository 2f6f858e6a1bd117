"""The port's LZHUF decode (tpz_torch/kernels/lzhuf_walk.py) held against
the JAX package: build_tables against JAX's, the plain token walk against
the lane-parallel _walk_vz, the host layout against the arrays JAX's
decompress_many builds, walk + materialize + placement + resolve against
JAX's _decode_fn (with _walk_vz and the doubling resolve), and the slice
through tpz_torch.api on device="cpu" against the inputs. Streams come
from the port's encoder and the C++ oracle; everything compared is an
integer, so the tolerance is exact equality.

JAX's decompress_many calls tpz.oracle, whose library Tier-1 never builds;
the tests that run it point it at the library tpz_torch.oracle builds,
for that test only."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpz.api as japi
import tpz.oracle as joracle
from tpz.codecs import lzhuf as jlzhuf
from tpz.kernels import lzhuf_walk as jlw
from tpz_torch import api, errors, oracle
from tpz_torch import constants as C
from tpz_torch.codecs import lzhuf
from tpz_torch.kernels import lzhuf_walk as lw
from tpz_torch.utils import corpus

LAYOUT_KEYS = ("stream_words", "body_bit_local", "out_len", "carry_len",
               "carry", "dense_off", "tab")
WALK_KEYS = ("stream_words", "body_bit_local", "out_len", "carry_len", "tab")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain walk runs many tiny torch ops, for which intra-op threads
    only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_oracle(monkeypatch):
    """tpz.oracle loading the library tpz_torch.oracle builds."""
    path = oracle.build()
    monkeypatch.setattr(joracle, "_LIB", None)
    monkeypatch.setattr(joracle, "_find_lib", lambda: path)
    return joracle


def _layout(streams, bits, seg_out=lw.BLOCK):
    """The port's host layout of raw bodies `streams` ((body, orig_size)),
    cut into segments of at most seg_out output bytes."""
    np_ = oracle._lzhuf_np(bits)
    entries = []
    for body, n in streams:
        idx = oracle.lzhuf_index(body, n, bits, seg_out=seg_out)
        spans = (idx["end_bits"] + 7) // 8 + 1 - idx["seg_bits"] // 8
        entries.append((body, idx, spans, lw._segment_tables(idx, np_)))
    return lw._layout(entries)


def _bodies(datas, bits):
    return [(oracle.lzhuf_encode(d, bits, 16), len(d)) for d in datas]


# Multi-segment with split-match carries (16 KiB segments), level-2 codes
# (lh7 mixed has 13-bit c codes), and constant-code blocks (b"x": one c
# symbol; b"a" * 5000: one p symbol).
WALK_CASES = {
    "lh5-text": (13, [corpus.text(40_000, seed=3)]),
    "lh7-mixed": (16, [corpus.mixed(60_000, seed=5)]),
    "lh5-constant-codes": (13, [b"a" * 5000, b"x"]),
}


@pytest.fixture(scope="module", params=list(WALK_CASES))
def walk_case(request):
    bits, datas = WALK_CASES[request.param]
    streams = _bodies(datas, bits)
    return request.param, bits, datas, streams, _layout(streams, bits,
                                                        1 << 14)


def test_walk_cases_cover_what_they_claim(walk_case):
    name, bits, _, streams, L = walk_case
    idx = [oracle.lzhuf_index(b, n, bits, seg_out=1 << 14)
           for b, n in streams]
    if name == "lh5-constant-codes":
        assert idx[1]["c_consts"][0] == ord("x")
        assert idx[0]["p_consts"][0] >= 0
    else:
        assert len(L["out_len"]) >= 3 and (L["carry_len"] > 0).any()
    if name == "lh7-mixed":
        assert idx[0]["c_lens"].max() > lw.L1_BITS


def test_build_tables_equals_jax_on_stream_tables(walk_case):
    _, bits, _, streams, _ = walk_case
    for body, n in streams:
        idx = oracle.lzhuf_index(body, n, bits, seg_out=1 << 14)
        for lens, consts, nsym in ((idx["c_lens"], idx["c_consts"], lw.NC),
                                   (idx["p_lens"], idx["p_consts"],
                                    oracle._lzhuf_np(bits))):
            got = lw.build_tables(lens, consts, nsym)
            want = jlw.build_tables(lens, consts, nsym)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_build_tables_equals_jax_on_long_codes_and_overflow():
    nsym = lw.NC
    # A complete code with lengths 1..16, 16: five codes past 12 bits, in
    # one level-2 chunk; then a block whose 13-bit codes need more than
    # L2_CAP / 32 chunks (None); then a constant block.
    deep = np.zeros((2, nsym), np.uint8)
    deep[0, :17] = [*range(1, 17), 16]
    deep[1, 5:505:2] = 9
    deep[1, 6:506:2] = 13
    consts = np.array([-1, 7], np.int32)
    got, want = lw.build_tables(deep, consts, nsym), jlw.build_tables(
        deep, consts, nsym)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][0] & 31 == 31).any() and (got[0][1] != 0).any()
    np.testing.assert_array_equal(got[0][1], 7 << 5)
    wide = np.zeros((1, nsym), np.uint8)
    wide[0, :300] = 13
    wide[0, 300:500] = 9
    assert lw.build_tables(wide, np.array([-1]), nsym) is None
    assert jlw.build_tables(wide, np.array([-1]), nsym) is None


def test_walk_plain_matches_jax_walk_vz(walk_case):
    *_, L = walk_case
    want = np.asarray(jax.jit(jlw._walk_vz)(
        *(jnp.asarray(L[k]) for k in WALK_KEYS)))
    got = lw.lzhuf_walk(*(torch.from_numpy(L[k]) for k in WALK_KEYS))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() >> 28 == 2).any()


def test_decode_stages_match_jax_decode_fn(walk_case, monkeypatch):
    """Walk, materialize, placement and the dist_bias=1 resolve equal
    JAX's _decode_fn with its lane-parallel walk and doubling resolve."""
    monkeypatch.setenv("TPZ_LZHUF_WALK", "vz")
    _, _, datas, _, L = walk_case
    want = np.asarray(jlw._decode_fn(
        *(jnp.asarray(L[k].astype(np.int32)) for k in LAYOUT_KEYS),
        interpret=True))
    t = {k: torch.from_numpy(v) for k, v in L.items()}
    got = lw._decode(t).numpy()
    total = int(L["out_len"].sum())
    np.testing.assert_array_equal(got[:total], want[:total])
    assert got[:total].tobytes() == b"".join(datas)


def _capture_port(monkeypatch):
    seen = {}

    def fake(t, stage_hook=None):
        seen.update({k: v.numpy() for k, v in t.items()})
        return torch.zeros(int(t["out_len"].sum()) + 128, dtype=torch.uint8)

    monkeypatch.setattr(lw, "_decode", fake)
    return seen


def test_layout_matches_jax_decompress_many(jax_oracle, monkeypatch):
    """Three streams, the first cut into three segments at its blocks'
    table changes: the port's device layout equals the arrays JAX's
    decompress_many hands its device function."""
    datas = [corpus.mixed(70_000, seed=8), b"a" * 5000,
             corpus.text(9000, seed=9)]
    items = _bodies(datas, 13)
    seen_j = {}

    def fake_j(*args, **kw):
        seen_j["args"] = [np.asarray(a) for a in args]
        return jnp.zeros(sum(len(d) for d in datas) + 128, jnp.uint8)

    monkeypatch.setattr(jlw, "_decode_fn", fake_j)
    jlw.decompress_many(items, 13, interpret=True)
    seen = _capture_port(monkeypatch)
    lw.decompress_many(items, 13, "cpu")
    np.testing.assert_array_equal(seen["out_len"],
                                  [32768, 32768, 4464, 5000, 9000])
    for name, arr in zip(LAYOUT_KEYS, seen_j["args"]):
        np.testing.assert_array_equal(seen[name], arr, err_msg=name)


def _container(method, d, body):
    return b"TPZL" + method.encode() + struct.pack("<Q", len(d)) + body


@pytest.mark.parametrize("method", ["lh4", "lh5", "lh6", "lh7"])
def test_decode_slice_round_trips(method):
    """The port's streams and the oracle's, one batch per method, through
    api.decompress_many; one through api.decompress."""
    bits = C.LZHUF_METHODS[method][0]
    datas = [corpus.text(12_000, seed=31), b"a" * 5000, b"x", b"",
             corpus.random_bytes(1500, seed=32)]
    mine = api.compress_many(datas, method, device="cpu")
    theirs = [_container(method, d, oracle.lzhuf_encode(d, bits, 16))
              for d in datas]
    before = lw.host_declines
    assert api.decompress_many(mine + theirs, method,
                               device="cpu") == datas + datas
    assert api.decompress(theirs[0], method, device="cpu") == datas[0]
    assert lw.host_declines == before


def test_decode_slice_groups_methods_over_several_segments():
    """A batch of two methods (grouped by dictionary size) whose lh5
    stream spans five segments (the encoder's 32 KiB blocks)."""
    rep = corpus.repetitive(150_000, seed=41)
    idx = oracle.lzhuf_index(oracle.lzhuf_encode(rep, 13, 16), len(rep), 13,
                             seg_out=lw.BLOCK)
    assert len(idx["out_lens"]) == 5
    small = corpus.text(3000, seed=42)
    blobs = [api.compress(rep, "lh5", device="cpu"),
             api.compress(small, "lh7", device="cpu")]
    before = lw.host_declines
    assert lzhuf.decompress_many(blobs, device="cpu") == [rep, small]
    assert lw.host_declines == before
    with pytest.raises(errors.DataError, match="method"):
        api.decompress_many(blobs, "lh5", device="cpu")


@pytest.mark.parametrize("delta", [100, -100, (1 << 24) + 1 - 20_000],
                         ids=["longer", "shorter", "above-2^24"])
def test_wrong_size_declines_and_raises(delta):
    d = corpus.text(20_000, seed=51)
    body = oracle.lzhuf_encode(d, 13, 16)
    before = lw.host_declines
    with pytest.raises((errors.DataError, errors.UnexpectedEof)):
        lw.decompress(body, len(d) + delta, 13, "cpu")
    assert lw.host_declines == before + 1


def test_corrupt_body_declines_and_raises():
    d = corpus.text(20_000, seed=52)
    blob = bytearray(api.compress(d, "lh5", device="cpu"))
    for k in range(215, 275, 3):
        blob[k] ^= 0x5A
    before = lw.host_declines
    with pytest.raises(errors.DataError):
        api.decompress(bytes(blob), "lh5", device="cpu")
    assert lw.host_declines == before + 1


def test_level2_overflow_declines_to_the_host(monkeypatch):
    d = corpus.text(5000, seed=53)
    blob = api.compress(d, "lh6", device="cpu")
    monkeypatch.setattr(lw, "build_tables", lambda *a: None)
    before = lw.host_declines
    assert api.decompress_many([blob, blob], "lh6", device="cpu") == [d, d]
    assert lw.host_declines == before + 2


def test_walk_rejects_unsupported_device():
    z = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        lw.lzhuf_walk(z, z[:, 0], z[:, 0], z[:, 0], z)


def _bad_method_blobs():
    good = api.compress(b"tpz lzhuf container", "lh5", device="cpu")
    return {"lh9": good[:4] + b"lh9" + good[7:],
            "non-utf8": good[:4] + b"\xff\xfe5" + good[7:]}


F4_CALLS = {
    "decompress": (lambda b: lzhuf.decompress(b, device="cpu"),
                   lambda b: jlzhuf.decompress(b)),
    "decompress_many": (lambda b: lzhuf.decompress_many([b], device="cpu"),
                        lambda b: jlzhuf.decompress_many([b])),
    "api-lh5": (lambda b: api.decompress(b, "lh5", device="cpu"),
                lambda b: japi.decompress(b, "lh5")),
    "stream-lh5": (lambda b: _stream(api.DecodeStream("lh5"), b),
                   lambda b: _stream(japi.DecodeStream("lh5"), b)),
}
# R9: the reference raises an error that is no CompressionError for these
# (ValueError from _dict_bits, UnicodeDecodeError from the method bytes);
# the port raises DataError. None where both raise the same DataError.
F4_REFERENCE = {
    ("lh9", "decompress"): ValueError,
    ("lh9", "decompress_many"): ValueError,
    ("lh9", "api-lh5"): None,
    ("lh9", "stream-lh5"): None,
    ("non-utf8", "decompress"): UnicodeDecodeError,
    ("non-utf8", "decompress_many"): UnicodeDecodeError,
    ("non-utf8", "api-lh5"): UnicodeDecodeError,
    ("non-utf8", "stream-lh5"): UnicodeDecodeError,
}


def _stream(s, blob):
    s.write(blob)
    return s.finish()


@pytest.mark.parametrize("kind,call", sorted(F4_REFERENCE))
def test_bad_method_field_raises_data_error(kind, call):
    """F4 / R9: an unknown method ("lh9") or non-UTF-8 method bytes in the
    container. The port raises DataError in every entry point; the
    reference raises the errors F4_REFERENCE records."""
    blob = _bad_method_blobs()[kind]
    mine, ref = F4_CALLS[call]
    with pytest.raises(errors.DataError) as got:
        mine(blob)
    want = F4_REFERENCE[(kind, call)]
    with pytest.raises(Exception) as ref_got:
        ref(blob)
    if want is None:
        assert type(ref_got.value).__name__ == "DataError"
        assert str(ref_got.value) == str(got.value)
    else:
        assert type(ref_got.value) is want
        assert not isinstance(ref_got.value, errors.CompressionError)
