"""The inverse BWT's kernel design (tpz_torch/csrc/ibwt_walk.cu) held
against the plain walk and the JAX package on the CPU.

`ibwt_rank_plain` is the kernels' torch twin, vectorised over chains: the
walk stages each chain's bytes in chunks (its own, then chunks linked from
its block's pool), the stitch checks that the live chains' successors are
a permutation of them and ranks them by pointer jumping cut at the start
chain (whose total must be n: then its cycle holds every live chain),
and the placement copies the chunks to each chain's offset. Its bytes
and flags must equal `ibwt_walk_plain`'s (the serial stitch's checks)
and JAX's `ibwt_body` in interpret mode: on real blocks at N = 32,768, a
periodic block (several LF cycles), rows whose length or orig pointer is
out of range, strides from 1 to 8,192, and chains longer than a chunk.
Bytes and flags are integers: the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ibwt import (_bwt_np, _oracle_block, _rows,  # noqa: F401
                             one_torch_thread)
from tpz.kernels import ibwt_walk as jiw
from tpz_torch.kernels import ibwt_walk as iw
from tpz_torch.utils import corpus


def _inputs(last, lens, origs):
    return iw.lf_inputs(torch.from_numpy(last),
                        torch.from_numpy(np.asarray(lens, np.int64)),
                        torch.from_numpy(np.asarray(origs, np.int64)))


def _check(last, lens, origs, seg, cap=None):
    """Twin against the plain walk at stride seg: (out, flag, the
    staging stats)."""
    w, start_g, length, valid = _inputs(last, lens, origs)
    want, wflag = iw.ibwt_walk_plain(w, start_g, length, seg)
    got, flag, stats = iw.ibwt_rank_plain(w, start_g, length, seg, cap)
    np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                  err_msg=f"seg {seg}, cap {cap}")
    np.testing.assert_array_equal(flag.numpy(), wflag.numpy())
    flag = flag | (~valid).to(torch.int32)
    return got.numpy(), flag.numpy(), stats


def _jax(last, lens, origs):
    out, flag = jiw.ibwt_body(jnp.asarray(last.astype(np.int32)),
                              jnp.asarray(np.asarray(lens, np.int32)),
                              jnp.asarray(np.asarray(origs, np.int32)),
                              N=last.shape[1], interpret=True)
    return np.asarray(out), np.asarray(flag)


@pytest.fixture(scope="module")
def real_blocks():
    """Two real blocks (text and mixed, about 25 kB) at N = 32,768, where
    JAX's slot walk decodes them, and the inputs."""
    datas = [corpus.text(26_000, seed=61), corpus.mixed(24_000, seed=62)]
    blocks = [_oracle_block(d) for d in datas]
    return blocks, _rows(blocks, 32768)


def test_twin_equals_plain_and_jax_on_real_blocks(real_blocks):
    blocks, (last, lens, origs) = real_blocks
    out, flag, (chunks, spilled) = _check(last, lens, origs, iw.IBWT_SEG)
    jout, jflag = _jax(last, lens, origs)
    assert flag.tolist() == jflag.tolist() == [0, 0]
    for b, (_, n, _, _) in enumerate(blocks):
        np.testing.assert_array_equal(out[b, :n], jout[b, :n])
    # At a chunk of twice the mean chain, some chains link pool chunks.
    assert chunks > 0 and spilled == 0


@pytest.mark.parametrize("seg", [16, 64, 128])
def test_twin_at_candidate_strides(real_blocks, seg):
    """The strides ibwt_stride.py times around IBWT_SEG."""
    _, (last, lens, origs) = real_blocks
    _, flag, _ = _check(last, lens, origs, seg)
    assert flag.tolist() == [0, 0]


def test_periodic_abc_block_flagged():
    """b"abc" repeated: the LF map is three cycles, so the successors are
    a permutation that never comes back to the start chain from two
    thirds of the chains. Both versions and JAX flag the block, and the
    aperiodic block beside it decodes."""
    rng = np.random.default_rng(11)
    abc = _oracle_block(b"abc" * 4000)
    other = bytes(rng.integers(0, 4, 3000, dtype=np.uint8))
    lc, o = _bwt_np(other)
    last, lens, origs = _rows([abc, (lc, len(other), o)], 16384)
    out, flag, _ = _check(last, lens, origs, iw.IBWT_SEG)
    _, jflag = _jax(last, lens, origs)
    assert flag.tolist() == [1, 0] and jflag[0] == 1
    assert (out[0] == 0).all() and out[1, :3000].tobytes() == other


def test_out_of_range_rows_flagged():
    """Length 0, a length above N and an orig pointer at the length are
    flagged and leave their rows zero; the valid row beside them
    decodes."""
    s = b"hello, hello world"
    lc, o = _bwt_np(s)
    last = np.zeros((4, 32), np.uint8)
    last[:, :len(s)] = lc
    out, flag, _ = _check(last, [len(s), 0, 40, len(s)],
                          [o, 0, o, len(s)], 4)
    assert flag.tolist() == [0, 1, 1, 1]
    assert out[0, :len(s)].tobytes() == s and (out[1:] == 0).all()


@pytest.mark.parametrize("seg", [1, 2, 8, 64, 512, 4096, 8192])
def test_every_stride(seg):
    """From one chain per node (seg 1, 8,193 chains) to one regular chain
    and the start chain (seg 4,096 > n, and 8,192 = N)."""
    data = corpus.mixed(3000, seed=64)
    lc, length, orig, _ = _oracle_block(data)
    last, lens, origs = _rows([(lc, length, orig)], 8192)
    out, flag, _ = _check(last, lens, origs, seg)
    assert flag.tolist() == [0]
    assert out[0, length:].max() == 0


@pytest.mark.parametrize("cap", [4, 16])
def test_chains_longer_than_a_chunk(cap):
    """Chunks far shorter than the chains (4 and 16 bytes at stride 256):
    nearly every chain links pool chunks, several in turn, and the bytes
    come out the same; the pool never runs dry for a valid block."""
    data = corpus.text(6000, seed=65)
    lc, length, orig, _ = _oracle_block(data)
    last, lens, origs = _rows([(lc, length, orig)], 8192)
    _, flag, (chunks, spilled) = _check(last, lens, origs, 256, cap)
    assert flag.tolist() == [0]
    assert chunks >= length // cap - 40 and spilled == 0


def test_default_chunk_and_pool():
    """The kernels' staging chunk is twice the stride (at least 16 bytes,
    a multiple of 4), and a pool of N / cap + 1 chunks holds every chunk
    past the first that chains covering N bytes can take."""
    for seg in (1, 2, 8, 64, 4096):
        cap = iw.stage_cap(seg)
        assert cap % 4 == 0 and cap >= max(16, 2 * seg)
        assert iw.pool_chunks(1 << 20, cap) * cap > 1 << 20
