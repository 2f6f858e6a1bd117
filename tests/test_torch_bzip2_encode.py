"""The port's bzip2 encode on the CPU, stage by stage against JAX's
(tpz/kernels/bwt.py, mtf.py, rle.py, bzip2_plan_device.py and the front
half of bzip2_pipeline.py) on the same inputs made from a numpy seed, and
end to end: `compress_many(..., device="cpu")` gives the bytes of
oracle.bzip2_encode at levels 1 and 9, which bz2 and the port's own decode
read back. Everything compared is integer or bytes: the tolerance is exact
equality.

The plain MTF costs about 10 us of CPU per symbol and the port's plain
decode walk about 0.5 ms per symbol, so blocks stay small: the port's
decode reads back the streams of a few thousand symbols, bz2 all."""

import bz2

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz import oracle as joracle
from tpz.kernels import bwt as jbwt
from tpz.kernels import bzip2_pipeline as jbp
from tpz.kernels import bzip2_plan_device as jpd
from tpz.kernels import mtf as jmtf
from tpz.kernels import rle as jrle
from tpz_torch import api, oracle
from tpz_torch.kernels import bwt, bzip2_pipeline as bp, bzip2_plan_device
from tpz_torch.kernels import mtf, rle
from tpz_torch.utils import corpus

N_SMALL = 8192
# Three level-1 blocks after RLE1.
BIG_L1 = corpus.mixed(250_000, seed=7)
RNG = np.random.default_rng(9)
# The edge shapes of tests/test_bzip2_pipeline.py's coder test: tiny
# streams (2 tables), all 256 byte values, incompressible bytes,
# concentrated frequencies; plus a periodic block (every doubling round
# runs) and a 6-table stream.
EDGE = {
    "a": b"a",
    "ab60": b"ab" * 60,
    "all256": bytes(range(256)) * 40,
    "random": bytes(RNG.integers(0, 256, 5000, dtype=np.uint8)),
    "concentrated": b"\x00" * 5000 + bytes(range(256)),
    "periodic": b"abc" * 3000,
    "mixed": corpus.mixed(7000, seed=77),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Intra-op threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_oracle(monkeypatch):
    """tpz.oracle loading the library tpz_torch.oracle builds (Tier-1
    never builds the reference's own)."""
    path = oracle.build()
    monkeypatch.setattr(joracle, "_LIB", None)
    monkeypatch.setattr(joracle, "_find_lib", lambda: path)
    return joracle


def _rows(datas, N):
    rows = np.zeros((len(datas), N), np.uint8)
    for i, d in enumerate(datas):
        rows[i, :len(d)] = np.frombuffer(d, np.uint8)
    return rows, np.array([len(d) for d in datas], np.int32)


def _rle1_rows(datas, level=9):
    """The host RLE1 of `datas` as one batch of block rows."""
    return bp.block_rows(bp.stream_blocks(
        [oracle.bzip2_rle1(d, level) for d in datas]))


def test_cyclic_words_device_matches_numpy():
    """Lengths 0 (a pad row), 1-3 (the row wraps more than once), 4, 5,
    100 and N; bytes >= 0x80 included."""
    N = 128
    lens = np.array([0, 1, 2, 3, 4, 5, 100, N], np.int64)
    blocks = RNG.integers(0, 256, (lens.size, N), dtype=np.uint8)
    blocks[np.arange(N)[None, :] >= lens[:, None]] = 0
    want = jbwt.cyclic_words(blocks, lens)
    np.testing.assert_array_equal(bwt.cyclic_words(blocks, lens), want)
    got = bwt.cyclic_words_device(torch.from_numpy(blocks),
                                  torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_bwt_matches_jax_and_the_oracle():
    """Text, mixed, repetitive, periodic (b"abc" * k, ties broken by
    index), random and 1-byte blocks at N = 8,192."""
    datas = [corpus.text(5000, seed=1), corpus.mixed(8000, seed=2),
             corpus.repetitive(6000, seed=3), b"abc" * 1000, b"x",
             b"banana", corpus.random_bytes(3000, seed=4), b"aaaa"]
    rows, n = _rows(datas, N_SMALL)
    rounds = (N_SMALL - 1).bit_length()
    w = bwt.cyclic_words_device(torch.from_numpy(rows), torch.from_numpy(n))
    last, orig = bwt.bwt_batched(w, torch.from_numpy(n))
    jlast, jorig = jbwt._bwt_batched(
        jnp.asarray(jbwt.cyclic_words(rows, n)), jnp.asarray(n), rounds)
    jlast, jorig = np.asarray(jlast), np.asarray(jorig)
    np.testing.assert_array_equal(orig.numpy(), jorig)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(last[i, :len(d)].numpy(),
                                      jlast[i, :len(d)])
        ref_last, ref_orig = oracle.bwt_ref(d)
        np.testing.assert_array_equal(last[i, :len(d)].numpy(), ref_last)
        assert int(orig[i]) == ref_orig


def test_bwt_exits_early_on_text():
    """Rotations of real text are distinct after a few doubling rounds;
    a periodic block runs them all."""
    for d, rounds in ((corpus.text(6000, seed=5), None), (b"ab" * 500, 13)):
        rows, n = _rows([d], N_SMALL)
        n_t = torch.from_numpy(n)
        bwt.bwt_batched(bwt.cyclic_words_device(torch.from_numpy(rows), n_t),
                        n_t)
        if rounds is None:
            assert 1 <= bwt.bwt_batched.rounds <= 6
        else:
            assert bwt.bwt_batched.rounds == rounds


@pytest.mark.parametrize("alpha", [256, 6])
def test_mtf_ranks_plain_matches_jax(alpha):
    """Skewed symbols (runs of repeats, as after a BWT), ragged lengths,
    the chunk edge crossed; zeros past each length."""
    n = 5000
    v = RNG.integers(0, alpha, (3, n)).astype(np.int32)
    v[0, 1000:3000] = RNG.integers(0, 2, 2000)
    v[1, :] = np.repeat(RNG.integers(0, alpha, n // 50 + 1), 50)[:n]
    length = np.array([n, 4097, 17], np.int32)
    got = mtf.mtf_ranks_plain(torch.from_numpy(v), torch.from_numpy(length),
                              alpha).numpy()
    want = np.asarray(jmtf.mtf_ranks(jnp.asarray(v), jnp.asarray(length),
                                     alpha=alpha))
    live = np.arange(n)[None, :] < length[:, None]
    np.testing.assert_array_equal(got * live, want * live)
    assert not got[~live].any()
    before = mtf.mtf_ranks.launches
    np.testing.assert_array_equal(
        mtf.mtf_ranks(torch.from_numpy(v), torch.from_numpy(length),
                      alpha).numpy(), got)
    assert mtf.mtf_ranks.launches == before


def test_rle2_encode_matches_jax():
    """Zero runs of every length from 1 to 40 and long ones (2^k - 1 and
    2^k: the digit count's edges), at the row ends too; ragged lengths."""
    n = 6000
    r = RNG.integers(0, 5, (3, n)).astype(np.int32)
    pos = 100
    for m in list(range(1, 41)) + [63, 64, 127, 128, 255, 256, 1000]:
        r[0, pos:pos + m] = 0
        r[0, pos + m] = 3
        pos += m + 1
    r[1, :] = 0
    r[1, 2000:2003] = 7
    r[2, n - 300:] = 0
    length = np.array([n, n, n - 5], np.int32)
    syms, sym_len = rle.rle2_encode(torch.from_numpy(r),
                                    torch.from_numpy(length))
    jsyms, jlen = jrle.rle2_encode(jnp.asarray(r), jnp.asarray(length))
    np.testing.assert_array_equal(sym_len.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(syms.numpy(), np.asarray(jsyms))


@pytest.fixture(scope="module")
def front():
    """JAX's front half (BWT, used map, MTF, RLE2) and the port's on the
    RLE1 blocks of the edge cases at level 9: (port's, JAX's), each (orig,
    syms, sym_len, used, n_used) numpy."""
    rows, lens, crcs, _ = _rle1_rows(list(EDGE.values()))
    rounds = (rows.shape[1] - 1).bit_length()
    jout = jax.jit(jbp._fused_bwt_mtf_fn, static_argnames=("rounds",))(
        jnp.asarray(jbwt.cyclic_words(rows, lens)), jnp.asarray(lens),
        rounds=rounds)
    out = bp._fused_bwt_mtf(torch.from_numpy(rows), torch.from_numpy(lens),
                            lambda stage: None)
    return ([x.numpy() for x in out], [np.asarray(x) for x in jout],
            crcs)


def test_front_stages_match_jax(front):
    (orig, syms, sym_len, used, n_used), (jorig, jsyms, jlen, jused,
                                          jn_used), _ = front
    np.testing.assert_array_equal(orig, jorig)
    np.testing.assert_array_equal(sym_len, jlen)
    np.testing.assert_array_equal(syms, jsyms)
    np.testing.assert_array_equal(used, jused)
    np.testing.assert_array_equal(n_used, jn_used)


def test_encode_blocks_matches_jax(front):
    """The coder's slots (values where a slot is live, widths, totals) on
    JAX's front-half output: the partition's take-one quirk, ties in the
    table costs, 2 to 6 tables and the selector MTF at alpha 6."""
    _, (orig, syms, sym_len, used, n_used), crcs = front
    vals, nbits, total = bzip2_plan_device.encode_blocks(
        *(torch.from_numpy(np.array(x, np.int32))
          for x in (syms, sym_len, used, n_used, orig)),
        torch.from_numpy(crcs))
    jvals, jnbits, jtotal = jpd.encode_blocks(
        *(jnp.asarray(x) for x in (syms, sym_len, used, n_used, orig)),
        jnp.asarray(crcs.astype(np.uint32)))
    jnbits = np.asarray(jnbits)
    np.testing.assert_array_equal(nbits.numpy(), jnbits)
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))
    live = jnbits > 0
    np.testing.assert_array_equal(vals.numpy()[live],
                                  np.asarray(jvals).astype(np.int64)[live])
    nt = np.asarray(vals.numpy()[:, 23])         # the 3-bit table count
    assert nt.min() == 2 and nt.max() == 6


@pytest.mark.parametrize("level", [1, 9])
def test_compress_many_matches_the_oracle(level):
    """The edge cases and b"" in one batch: bytes equal
    oracle.bzip2_encode's, and bz2 and the port's decode read every
    stream back."""
    datas = [b"", *EDGE.values()]
    blobs = bp.compress_many(datas, level, "cpu")
    for d, blob in zip(datas, blobs):
        assert blob == oracle.bzip2_encode(d, level)
        assert bz2.decompress(blob) == d
    assert api.decompress_many(blobs, "bzip2", device="cpu") == datas


@pytest.mark.parametrize("level", [1, 9])
def test_multi_block_buffer_matches_the_oracle(level):
    """120 kB of corpus.mixed: two blocks at level 1, one at level 9;
    bz2 reads them back (the port's plain decode walk would take a minute
    for this many symbols)."""
    data = corpus.mixed(120_000, seed=78)
    blob = bp.compress(data, level, "cpu")
    assert blob == oracle.bzip2_encode(data, level)
    assert bz2.decompress(blob) == data
    assert len(oracle.bzip2_rle1(data, level)[2]) == (2 if level == 1 else 1)


def test_compress_many_matches_jax_pipeline(jax_oracle):
    """JAX's whole encode program and the port's give the same streams."""
    datas = [EDGE["mixed"], b"", EDGE["all256"]]
    assert bp.compress_many(datas, 9, "cpu") == jbp.compress_many(datas, 9)


@pytest.mark.parametrize("max_blocks,dispatches", [
    (1, [1, 1, 1, 1, 1]), (2, [2, 2, 1]), (4, [4, 1])])
def test_dispatches_split_anywhere(monkeypatch, max_blocks, dispatches):
    """Above MAX_DISPATCH_BLOCKS blocks a batch runs in several dispatches,
    cut between any two blocks, inside a buffer too: a buffer of three
    level-1 blocks between two of one. The bytes stay the oracle's."""
    monkeypatch.setattr(bp, "MAX_DISPATCH_BLOCKS", max_blocks)
    calls = []
    real = bp._encode_dispatch

    def spy(blocks, *a):
        calls.append(len(blocks))
        return real(blocks, *a)

    monkeypatch.setattr(bp, "_encode_dispatch", spy)
    datas = [corpus.text(3000, seed=6), BIG_L1, b"x"]
    assert bp.compress_many(datas, 1, "cpu") == [
        oracle.bzip2_encode(d, 1) for d in datas]
    assert calls == dispatches


def test_api_accepts_bzip2():
    data = corpus.text(4000, seed=8)
    assert api.compress(data, "bzip2", 9, device="cpu") == \
        oracle.bzip2_encode(data, 9)
    assert api.compress_many([data, b""], "bzip2", 1, device="cpu") == [
        oracle.bzip2_encode(data, 1), oracle.bzip2_encode(b"", 1)]
    assert bp.empty_stream(0) == oracle.bzip2_encode(b"", 1)
