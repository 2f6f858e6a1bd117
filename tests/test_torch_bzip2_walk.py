"""The port's bzip2 symbol walk (tpz_torch/kernels/bzip2_walk.py) held
against the JAX package: build_tables against JAX's, the plain walk's
records and meta against JAX's Pallas walk _walk_call in interpret mode,
the run expansion against the oracle's last columns, and the host layout
against the arrays JAX's decompress_walk_many hands its device program.
Streams come from stdlib bz2 and the C++ oracle; everything compared is
an integer, so the tolerance is exact equality.

JAX's pipeline calls tpz.oracle, whose library Tier-1 never builds; the
tests that run it point it at the library tpz_torch.oracle builds, for
that test only."""

import bz2
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpz.oracle as joracle
from tpz.kernels import bzip2_pipeline as jbp
from tpz.kernels import bzip2_walk as jbw
from tpz_torch import oracle
from tpz_torch.kernels import bzip2_pipeline as bp
from tpz_torch.kernels import bzip2_walk as bw
from tpz_torch.utils import corpus


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


def _layout(blobs):
    """The pipeline's host layout of the blocks of `blobs` (one level
    bucket): (scan, layout, N, S)."""
    level = max(bp._max_level(b) for b in blobs)
    N = bp._bucket(bw.rec_cap_for(level))
    scan, slices = bp.group_inputs(
        blobs, [oracle.bzip2_scan_headers(b) for b in blobs], N)
    return (scan, bw.block_layout(scan, slices), N,
            bw.records_cap(N, bw.rec_cap_for(level)))


def _zeroed(blob: bytes, at: int, n: int) -> bytes:
    b = bytearray(blob)
    b[at:at + n] = bytes(n)
    return bytes(b)


_TEXT = corpus.text(6000, seed=1)
# One-block streams of a few thousand symbols (JAX's interpreted walk
# costs about 1 s per 5,000, the plain walk about 0.5 ms a symbol), a
# two-block stream of corpus.repetitive, two blocks from two concatenated
# streams, a block of one symbol, and zeroed symbol bits (they decode as a
# run that outgrows 2^21: err 8 with the failing symbol's bit position).
WALK_CASES = {
    "stdlib-l1-text": lambda: bz2.compress(_TEXT, 1),
    "stdlib-l1-repetitive": lambda: bz2.compress(corpus.repetitive(
        210_000, seed=41), 1),
    "stdlib-l9-mixed": lambda: bz2.compress(corpus.mixed(6000, seed=2), 9),
    "oracle-l9-text": lambda: oracle.bzip2_encode(corpus.text(7000, seed=3),
                                                  9),
    "two-streams-l1": lambda: (bz2.compress(corpus.text(3000, seed=4), 1)
                               + oracle.bzip2_encode(corpus.mixed(
                                   3000, seed=5), 1)),
    "one-symbol": lambda: bz2.compress(b"a" * 5000, 9),
    "corrupt-symbols": lambda: _zeroed(bz2.compress(_TEXT, 1), 1000, 100),
}


def _port_walk(L, S):
    recs, meta = bw.bzip2_walk(*(torch.from_numpy(L[k]) for k in bw.WALK_ARGS),
                               S)
    return recs, meta


@functools.lru_cache(maxsize=None)
def _walked(name):
    """(name, scan, layout, N, S, the port's plain walk (recs, meta)) of
    a case, walked once per test process."""
    scan, L, N, S = _layout([WALK_CASES[name]()])
    return name, scan, L, N, S, _port_walk(L, S)


@pytest.fixture(params=list(WALK_CASES))
def walk_case(request):
    return _walked(request.param)


def test_walk_cases_cover_what_they_claim(walk_case):
    name, scan, _, _, _, (_, meta) = walk_case
    if name == "corrupt-symbols":
        assert meta[0, 1] & 1023 == 8 and meta[0, 1] >> 10 == meta[0, 2] + 1
    else:
        assert (meta[:, 1] == 0).all()
    if name in ("two-streams-l1", "stdlib-l1-repetitive"):
        assert len(scan["sym_bits"]) == 2
    if name == "one-symbol":
        # RLE1 leaves "aaaa" and its run-length bytes (251, then the tail).
        assert scan["n_useds"][0] == 3


def test_build_tables_equals_jax_on_stream_tables(walk_case):
    _, scan, L, *_ = walk_case
    np.testing.assert_array_equal(
        L["tab"], jbw.build_tables(scan["lens"], scan["n_useds"]))


def test_build_tables_equals_jax_on_long_codes():
    """Codes past 12 bits (level-2 entries): a 250 kB corpus.mixed block at
    level 9, and a complete synthetic code with lengths 1..17."""
    scan = oracle.bzip2_scan_headers(bz2.compress(
        corpus.mixed(250_000, seed=3), 9))
    assert scan["lens"].max() > bw.L1_BITS
    lens = np.concatenate([scan["lens"], np.zeros((1, 6, 258), np.uint8)])
    lens[1, 0, :18] = [*range(1, 18), 17]
    n_useds = np.concatenate([scan["n_useds"], [16]])
    got = bw.build_tables(lens, n_useds)
    np.testing.assert_array_equal(got, jbw.build_tables(lens, n_useds))
    tab = got.reshape(len(n_useds), 6, bw.TAB_STRIDE)
    assert ((tab[:, :, :bw.L1W] & 31) == 31).any()
    assert (tab[:, :, bw.L1W:] != 0).any()


def test_walk_plain_matches_jax_walk_call(walk_case):
    """Records up to each block's count, and meta (records, err, end
    bitpos), equal JAX's Pallas walk in interpret mode."""
    _, _, L, _, S, (recs, meta) = walk_case
    jrecs, jmeta = map(np.asarray, jbw._walk_call(
        *(jnp.asarray(L[k].astype(np.int32)) for k in bw.WALK_ARGS), S=S,
        interpret=True))
    recs, meta = recs.numpy(), meta.numpy()
    np.testing.assert_array_equal(meta, jmeta[:, :bw.META_WIDTH])
    for b, n in enumerate(meta[:, 0]):
        np.testing.assert_array_equal(recs[b, :n], jrecs[b, :n])
    assert (recs[np.arange(recs.shape[1])[None, :] >= meta[:, :1]] == 0).all()


@pytest.mark.parametrize("name", ["stdlib-l1-repetitive", "oracle-l9-text"])
def test_expansion_equals_the_oracles_last_columns(name):
    """The records, run-expanded, are each block's BWT last column as the
    host decoder (cpp Bzip2ScanToLast) builds it."""
    blob = WALK_CASES[name]()
    _, _, L, N, _, (recs, meta) = _walked(name)
    last, lens, err, orig = bw.expand_records(
        recs, meta, torch.from_numpy(L["origs"]), N)
    blob_l, offs, lens_l, origs_l, _ = oracle.bzip2_scan_to_last(blob)
    assert (err == 0).all()
    np.testing.assert_array_equal(lens.numpy(), lens_l)
    np.testing.assert_array_equal(orig.numpy(), origs_l)
    for b in range(len(offs)):
        np.testing.assert_array_equal(
            last[b, :lens_l[b]].numpy(),
            blob_l[offs[b]:offs[b] + lens_l[b]])
        assert (last[b, lens_l[b]:] == 0).all()


def test_expansion_marks_and_sanitizes_bad_rows():
    """err 32 where the records cover more than N bytes, 64 where orig is
    not below the length; such rows and walk-errored rows come back empty
    with length 1 and orig 0."""
    N, S = 64, 8
    recs = torch.tensor([[(40 << 8) | 7, (30 << 8) | 9, 0, 0, 0, 0, 0, 0],
                         [(3 << 8) | 1, (2 << 8) | 2, 0, 0, 0, 0, 0, 0],
                         [(3 << 8) | 1, 0, 0, 0, 0, 0, 0, 0],
                         [(5 << 8) | 4, (1 << 8) | 5, 0, 0, 0, 0, 0, 0]],
                        dtype=torch.int32)
    meta = torch.tensor([[2, 0, 0], [2, 0, 0], [1, 17 << 10 | 4, 0],
                         [2, 0, 0]], dtype=torch.int32)
    last, lens, err, orig = bw.expand_records(
        recs, meta, torch.tensor([3, 5, 0, 2]), N)
    assert err.tolist() == [32, 64, 17 << 10 | 4, 0]
    assert lens.tolist() == [1, 1, 1, 6] and orig.tolist() == [0, 0, 0, 2]
    assert (last[:3] == 0).all()
    assert last[3, :6].tolist() == [4, 4, 4, 4, 4, 5]
    assert (last[3, 6:] == 0).all() and last.shape == (4, N)


def test_layout_matches_jax_decompress_walk_many(jax_oracle, monkeypatch):
    """Three streams of two level buckets: the port's scan, slices and
    walk layout equal what JAX's decompress_walk_many hands
    decode_blocks_device, group by group."""
    blobs = [bz2.compress(corpus.text(3000, seed=7), 1),
             oracle.bzip2_encode(corpus.mixed(250_000, seed=8), 9),
             bz2.compress(corpus.mixed(4000, seed=9), 1)]
    seen_j, seen = [], []

    def declined(scan, N):
        nb = len(scan["sym_bits"])
        return (np.zeros((nb, N), np.uint8), np.ones(nb, np.int32),
                np.ones(nb, np.int32), np.zeros(nb, np.int32))

    def fake_j(scan, slices, N, interpret=None, rec_cap=None):
        seen_j.append((scan, slices, N, rec_cap))
        return (*declined(scan, N), False)  # the reference adds `ok`

    def fake(scan, slices, N, device, rec_cap=None, stage_hook=None):
        seen.append((scan, slices, N, rec_cap))
        return declined(scan, N)

    monkeypatch.setattr(jbw, "decode_blocks_device", fake_j)
    monkeypatch.setattr(bw, "decode_blocks_device", fake)
    assert jbp.decompress_walk_many(blobs) == [None] * 3
    assert bp.decompress_walk_many(blobs, "cpu") == [None] * 3
    assert [x[2] for x in seen] == [x[2] for x in seen_j] == [1 << 17,
                                                             1 << 20]
    for (scan, slices, N, cap), (jscan, jslices, _, jcap) in zip(seen,
                                                                seen_j):
        assert cap == jcap
        np.testing.assert_array_equal(slices, jslices)
        for k in jscan:
            np.testing.assert_array_equal(scan[k], jscan[k], err_msg=k)
        L = bw.block_layout(scan, slices)
        np.testing.assert_array_equal(
            L["sw"], np.ascontiguousarray(jslices).view(">u4").astype(
                np.int32))
        np.testing.assert_array_equal(
            L["sym_local"], (jscan["sym_bits"] & 7).astype(np.int32))


def test_scan_headers_equals_jax_binding(jax_oracle):
    """The port's ctypes binding of cpp Bzip2ScanHeaders returns what the
    reference's returns, and None for what it refuses."""
    blob = bz2.compress(corpus.mixed(150_000, seed=10), 1)
    got, want = oracle.bzip2_scan_headers(blob), jax_oracle.bzip2_scan_headers(
        blob)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert oracle.bzip2_scan_headers(b"not a bzip2 stream") is None
    assert jax_oracle.bzip2_scan_headers(b"not a bzip2 stream") is None


def test_walk_rejects_unsupported_device():
    z = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        bw.bzip2_walk(z[:, 0], z[:, 0], z[:, 0], z, z, z, z, 8)
