"""tpz_torch encode front (4-byte words and the spec-v3 suffix screen)
against the JAX reference, on CPU. Integer outputs: the tolerance is exact
equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels import deflate_pipeline as jdp
from tpz.kernels import matchfinder as jmf
from tpz.utils import corpus
from tpz_torch.kernels import deflate_pipeline as tdp
from tpz_torch.kernels import matchfinder as tmf


def _words_np(data: bytes, window: int, block: int, fwd: int, nb: int):
    """Haloed u32 LE 4-byte windows [nb, window + block + fwd] (numpy)."""
    span = np.zeros(window + nb * block + fwd, np.uint8)
    span[window:window + len(data)] = np.frombuffer(data, np.uint8)
    d = span.astype(np.uint32)
    w = (d | (np.roll(d, -1) << 8) | (np.roll(d, -2) << 16)
         | (np.roll(d, -3) << 24))
    m = window + block + fwd
    return np.stack([w[b * block:b * block + m] for b in range(nb)])


def _screen_both(words_u32, nb, n, block, window, r, screen_bytes, restart,
                 chunk=None):
    span_off = (np.arange(nb) * block).astype(np.int32)
    span_len = np.full(nb, n, np.int32)
    ref = jmf.suffix_screen_w(jnp.asarray(words_u32), jnp.asarray(span_off),
                              jnp.asarray(span_len), r, window, block, 258,
                              screen_bytes, restart)
    args = (torch.from_numpy(words_u32.view(np.int32)),
            torch.from_numpy(span_off), torch.from_numpy(span_len), r,
            window, block, 258, screen_bytes, restart)
    if chunk is None:
        got = tmf.suffix_screen_w(*args)
    else:
        got = tmf.suffix_screen_w_chunked(*args, chunk=chunk)
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def test_make_words_matches_reference():
    nb = 3
    data = corpus.mixed(nb * jmf.BLOCK - 777, seed=21)
    span = np.zeros(jmf.WINDOW + nb * jmf.BLOCK + jmf.FWD_PAD, np.uint8)
    span[jmf.WINDOW:jmf.WINDOW + len(data)] = np.frombuffer(data, np.uint8)
    ref = np.asarray(jdp._make_words(jnp.asarray(span))).view(np.int32)
    got = tdp._make_words(torch.from_numpy(span)).numpy()
    assert got.shape == (nb, jmf.M_TOTAL)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [1, 6])
def test_span_layout_matches_reference_words(seed):
    """The port's span layout + words equal the reference's for a batch
    of several buffers (halo words come from the shared span)."""
    datas = [corpus.text(70_000, seed=seed), corpus.random_bytes(5000)]
    span, span_off, span_len, block_len, buf_start, bfinal, nbs = \
        tdp.span_layout(datas)
    assert nbs == [2, 1]
    np.testing.assert_array_equal(block_len, [65536, 70_000 - 65536, 5000])
    np.testing.assert_array_equal(span_off, [0, 65536, 0])
    np.testing.assert_array_equal(buf_start, [True, False, True])
    np.testing.assert_array_equal(bfinal, [False, True, True])
    ref = np.asarray(jdp._make_words(jnp.asarray(span))).view(np.int32)
    np.testing.assert_array_equal(
        tdp._make_words(torch.from_numpy(span)).numpy(), ref)


@pytest.mark.parametrize("restart", [0, 256])
@pytest.mark.parametrize("r,screen_bytes", [(4, 16), (8, 16), (32, 32)])
def test_suffix_screen_small_geometry(r, screen_bytes, restart):
    """The test_kernels.py screen geometry (window 512, block 1024)."""
    window, block, fwd, nb = 512, 1024, 512, 5
    n = nb * block - 300
    words = _words_np(corpus.mixed(n, seed=31), window, block, fwd, nb)
    ref, got = _screen_both(words, nb, n, block, window, r, screen_bytes,
                            restart)
    for name, x, y in zip(("pk1", "pk2", "cap_at"), ref, got):
        np.testing.assert_array_equal(y, x, err_msg=name)


@pytest.mark.parametrize("screen_bytes,r", [(16, 8), (32, 32)])
def test_suffix_screen_full_block(screen_bytes, r):
    """One full-size block: WINDOW 32768, BLOCK 65536."""
    n = jmf.BLOCK
    words = _words_np(corpus.mixed(n, seed=41), jmf.WINDOW, jmf.BLOCK,
                      jmf.FWD_PAD, 1)
    ref, got = _screen_both(words, 1, n, jmf.BLOCK, jmf.WINDOW, r,
                            screen_bytes, 16384)
    for name, x, y in zip(("pk1", "pk2", "cap_at"), ref, got):
        np.testing.assert_array_equal(y, x, err_msg=name)


def test_suffix_screen_unsigned_keys():
    """Keys whose leading byte is >= 0x80 must sort after smaller ones
    (an int32 sort would put them first)."""
    window, block, fwd, nb = 512, 1024, 512, 2
    rng = np.random.default_rng(5)
    pat = [bytes(rng.integers(0x80, 0x100, 6, dtype=np.uint8)),
           bytes(rng.integers(0x00, 0x80, 6, dtype=np.uint8))]
    data = b"".join(pat[i % 2] + bytes([i % 7]) for i in range(280))[:1900]
    words = _words_np(data, window, block, fwd, nb)
    assert (words >> 24 >= 0x80).any() and (words >> 24 < 0x80).any()
    ref, got = _screen_both(words, nb, len(data), block, window, 8, 16, 256)
    for name, x, y in zip(("pk1", "pk2", "cap_at"), ref, got):
        np.testing.assert_array_equal(y, x, err_msg=name)
    assert (got[0] & 63).max() > 8  # long candidates were found


def test_suffix_screen_chunked_identity():
    """Row chunks (chunk=2, ragged last chunk) equal the unchunked screen
    and the reference."""
    window, block, fwd, nb = 512, 1024, 512, 5
    n = nb * block - 50
    words = _words_np(corpus.mixed(n, seed=33), window, block, fwd, nb)
    ref, whole = _screen_both(words, nb, n, block, window, 4, 16, 256)
    _, chunked = _screen_both(words, nb, n, block, window, 4, 16, 256,
                              chunk=2)
    for x, y, z in zip(ref, whole, chunked):
        np.testing.assert_array_equal(z, y)
        np.testing.assert_array_equal(z, x)
