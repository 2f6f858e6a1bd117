"""The port's inverse BWT (tpz_torch/kernels/ibwt_walk.py) held against the
JAX package's ibwt_body and ibwt_blocks_fast in interpret mode: the same
plaintext wherever JAX does not decline, periodic blocks flagged by both,
and the blocks JAX declines only for its slot-stream cap (N <= 16,384)
decoded by the port. Last columns come from a rotation sort in numpy, the
reference oracle's rotation sort (bwt_ref) and the C++ oracle's host
symbol decode; everything compared is a byte or a flag, so the tolerance
is exact equality."""

import bz2

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpz.oracle as joracle
from tpz.kernels import ibwt_walk as jiw
from tpz_torch import oracle
from tpz_torch.kernels import ibwt_walk as iw
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
    """tpz.oracle loading the library tpz_torch.oracle builds (Tier-1
    never builds the reference's own)."""
    path = oracle.build()
    monkeypatch.setattr(joracle, "_LIB", None)
    monkeypatch.setattr(joracle, "_find_lib", lambda: path)
    return joracle


def _bwt_np(s):
    """Rotation-sort BWT with rotation-index tie-breaks (as cpp/bzip2.cc
    BwtEncode)."""
    s = bytes(s)
    n = len(s)
    d = s + s
    rots = sorted(range(n), key=lambda i: d[i:i + n])
    last = np.frombuffer(bytes(s[(i + n - 1) % n] for i in rots),
                         np.uint8).copy()
    return last, rots.index(0)


def _pack(cases, N):
    last = np.zeros((len(cases), N), np.uint8)
    lens = np.zeros(len(cases), np.int64)
    origs = np.zeros(len(cases), np.int64)
    for b, s in enumerate(cases):
        lc, o = _bwt_np(s)
        last[b, :len(s)] = lc
        lens[b], origs[b] = len(s), o
    return last, lens, origs


def _oracle_block(data: bytes):
    """One block's BWT last column, length and orig pointer from the
    oracle's level-1 stream of `data` (its input is data after RLE1),
    and the stream itself."""
    blob = oracle.bzip2_encode(data, 1)
    last, offs, lens, origs, crcs = oracle.bzip2_scan_to_last(blob)
    assert len(offs) == 1
    return last[offs[0]:offs[0] + lens[0]], int(lens[0]), int(origs[0]), blob


def _rows(blocks, N):
    last = np.zeros((len(blocks), N), np.uint8)
    for b, (lc, *_) in enumerate(blocks):
        last[b, :len(lc)] = lc
    return (last, np.array([b[1] for b in blocks]),
            np.array([b[2] for b in blocks]))


def _port(last, lens, origs, seg=iw.IBWT_SEG):
    out, flag = iw.ibwt_body(torch.from_numpy(last),
                             torch.from_numpy(np.asarray(lens)),
                             torch.from_numpy(np.asarray(origs)), seg=seg)
    return out.numpy(), flag.numpy()


def _jax(last, lens, origs):
    out, flag = jiw.ibwt_body(jnp.asarray(last.astype(np.int32)),
                              jnp.asarray(np.asarray(lens, np.int32)),
                              jnp.asarray(np.asarray(origs, np.int32)),
                              N=last.shape[1], interpret=True)
    return np.asarray(out), np.asarray(flag)


def _round_trip(row, blob) -> bytes:
    """The stream's plaintext from one iBWT row: RLE1^-1 with its CRC."""
    _, _, lens, _, crcs = oracle.bzip2_scan_to_last(blob)
    return oracle.bzip2_rle1_inverse(row[:lens[0]], np.zeros(1, np.int64),
                                     lens, crcs)


def test_plain_matches_jax_ibwt_body_at_32768():
    """Two real blocks (text and mixed, about 25 kB) at N = 32,768, where
    JAX's slot walk decodes them: the same plaintext, which RLE1^-1 and
    the block CRC turn back into the input."""
    datas = [corpus.text(26_000, seed=61), corpus.mixed(24_000, seed=62)]
    blocks = [_oracle_block(d) for d in datas]
    last, lens, origs = _rows(blocks, 32768)
    out, flag = _port(last, lens, origs)
    jout, jflag = _jax(last, lens, origs)
    assert flag.tolist() == jflag.tolist() == [0, 0]
    for b, (d, (_, n, _, blob)) in enumerate(zip(datas, blocks)):
        np.testing.assert_array_equal(out[b, :n], jout[b, :n])
        assert (out[b, n:] == 0).all()
        assert _round_trip(out[b], blob) == d


def test_periodic_block_flagged_by_both():
    """A periodic block's LF map splits into disjoint cycles: both
    packages flag it (and the blocks beside it decode)."""
    rng = np.random.default_rng(11)
    cases = [b"banana_bandana_banana" * 30,
             bytes(rng.integers(0, 4, 500, dtype=np.uint8))]
    last, lens, origs = _pack(cases, 1024)
    out, flag = _port(last, lens, origs)
    _, jflag = _jax(last, lens, origs)
    assert flag.tolist() == [1, 0] and jflag[0] == 1
    assert out[1, :500].tobytes() == cases[1]
    assert iw.ibwt_blocks_fast(last, lens, origs, "cpu") is None
    assert jiw.ibwt_blocks_fast(last, lens, origs, interpret=True) is None


@pytest.mark.parametrize("kind, N, n, seed", [
    ("text", 8192, 5000, 0), ("text", 16384, 16000, 0),
    ("mixed", 8192, 5000, 1), ("mixed", 16384, 16000, 63)])
def test_port_decodes_blocks_jax_declines_for_capacity(jax_oracle, kind, N,
                                                       n, seed):
    """At N <= 16,384 JAX's slot streams (CAP) overflow on some real
    blocks, so it flags them; the port has no cap and decodes them. The
    BWT is the reference oracle's rotation sort of the raw input."""
    data = getattr(corpus, kind)(n, seed=seed)
    lc, orig = jax_oracle.bwt_ref(data)
    last, lens, origs = _rows([(lc, n, orig)], N)
    _, jflag = _jax(last, lens, origs)
    out, flag = _port(last, lens, origs)
    assert jflag.tolist() == [1] and flag.tolist() == [0]
    assert out[0, :n].tobytes() == data


def test_ibwt_blocks_fast_matches_the_reference_cases():
    """The reference's own iBWT cases (tests/test_ibwt_walk.py): one byte,
    two, skewed chains, 255 and 256 bytes, text."""
    rng = np.random.default_rng(11)
    cases = [bytes([7]), b"ab",
             bytes(rng.integers(0, 4, 100, dtype=np.uint8)),
             bytes(rng.integers(0, 256, 255, dtype=np.uint8)),
             bytes(rng.integers(0, 256, 256, dtype=np.uint8)),
             bytes(rng.integers(0, 4, 1000, dtype=np.uint8)),
             bytes(corpus.text(900))]
    last, lens, origs = _pack(cases, 1024)
    got = iw.ibwt_blocks_fast(last, lens, origs, "cpu")
    want = jiw.ibwt_blocks_fast(last, lens, origs, interpret=True)
    for b, s in enumerate(cases):
        assert got[b, :lens[b]].tobytes() == s
        np.testing.assert_array_equal(got[b, :lens[b]], want[b, :lens[b]])


@pytest.mark.parametrize("seg", [1, 2, 16, 256, 4096, 8192])
def test_every_stride_gives_the_same_plaintext(seg):
    """From one chain per node (seg 1) to one chain for the whole block
    (seg 4096 > n, and 8192 > N): the stitch places the same bytes."""
    data = corpus.mixed(3000, seed=64)
    lc, length, orig, blob = _oracle_block(data)
    last, lens, origs = _rows([(lc, length, orig)], 4096)
    out, flag = _port(last, lens, origs, seg=seg)
    assert flag.tolist() == [0]
    assert _round_trip(out[0], blob) == data


def test_out_of_range_rows_are_flagged():
    """Length 0, a length above N and an orig pointer at the length are
    flagged and leave their rows zero; the valid row beside them
    decodes."""
    s = b"hello, hello world"
    lc, o = _bwt_np(s)
    last = np.zeros((4, 32), np.uint8)
    last[:, :len(s)] = lc
    lens = [len(s), 0, 40, len(s)]
    origs = [o, 0, o, len(s)]
    out, flag = _port(last, lens, origs)
    assert flag.tolist() == [0, 1, 1, 1]
    assert out[0, :len(s)].tobytes() == s and (out[1:] == 0).all()


def test_stream_blocks_decode_through_the_second_route():
    """ibwt_blocks_fast on the oracle's last columns of a three-block
    stdlib stream, as the pipeline's second route calls it."""
    data = corpus.text(250_000, seed=65)
    blob = bz2.compress(data, 1)
    last_blob, offs, lens, origs, crcs = oracle.bzip2_scan_to_last(blob)
    N = 1 << 17
    last = np.zeros((len(offs), N), np.uint8)
    for b in range(len(offs)):
        last[b, :lens[b]] = last_blob[offs[b]:offs[b] + lens[b]]
    rows = iw.ibwt_blocks_fast(last, lens, origs, "cpu")
    assert oracle.bzip2_rle1_inverse(
        rows.reshape(-1), np.arange(len(offs), dtype=np.int64) * N, lens,
        crcs) == data


def test_ibwt_rejects_bad_arguments():
    z = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        iw.ibwt(z, z[:, 0], z[:, 0], 4)
    c = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        iw.ibwt(c, c[:, 0], c[:, 0] + 8, 3)
