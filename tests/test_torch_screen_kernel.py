"""The v3 screen's CUDA kernel (csrc/suffix_screen.cu, launched by
matchfinder.suffix_screen) against the plain version, suffix_screen_w, on
the card: pk1, pk2 and cap_at at every column, halo and forward pad
included, at the small geometry of test_torch_encode_front.py and at the
gzip6.archive cell's layout (2 x 16 MiB of corpus.mixed through
span_layout, _make_words and _zero_past_end), for every (r_neighbors,
screen_bytes) pair of the DEFLATE levels. The CPU tests hold the
wrapper's routing: a CPU tensor takes the plain version and launches
nothing; a pair with no kernel, or a device other than the CPU and CUDA,
raises. The file imports no JAX, and needs none of tests/conftest.py
(which imports JAX), so that the card runs it without that file:

    python3 -m pytest --noconftest tests/test_torch_screen_kernel.py -q
"""

import numpy as np
import pytest
import torch

from tpz_torch.kernels import deflate_pipeline as dp
from tpz_torch.kernels import matchfinder as mf
from tpz_torch.utils import corpus

PAIRS = mf.SCREEN_KERNEL_PAIRS
WINDOW, BLOCK, FWD, NB = 512, 1024, 512, 5   # the small geometry
MAX_MATCH = 258


def small_inputs(device, seed=31):
    """words, span_off, span_len of one buffer of NB * BLOCK - 300 bytes
    laid out in NB haloed rows of the small geometry."""
    n = NB * BLOCK - 300
    span = np.zeros(WINDOW + NB * BLOCK + FWD, np.uint8)
    span[WINDOW:WINDOW + n] = np.frombuffer(corpus.mixed(n, seed=seed),
                                            np.uint8)
    d = span.astype(np.uint32)
    w = (d | (np.roll(d, -1) << 8) | (np.roll(d, -2) << 16)
         | (np.roll(d, -3) << 24))
    m = WINDOW + BLOCK + FWD
    words = np.stack([w[b * BLOCK:b * BLOCK + m] for b in range(NB)])
    span_off = (np.arange(NB) * BLOCK).astype(np.int32)
    span_len = np.full(NB, n, np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (words.view(np.int32), span_off, span_len))


def meta_inputs():
    words = torch.empty((2, 2048), dtype=torch.int32, device="meta")
    so = torch.empty(2, dtype=torch.int32, device="meta")
    return words, so, so


def assert_equal(got, want):
    for name, g, w in zip(("pk1", "pk2", "cap_at"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), (
            f"{name}: {int((g != w).sum())} of {w.numel()} columns differ")


# ------------------------------------------------------------- the CPU


@pytest.mark.parametrize("r,screen_bytes", PAIRS)
def test_cpu_tensors_take_the_plain_screen(r, screen_bytes):
    words, so, sl = small_inputs("cpu")
    want = mf.suffix_screen_w(words, so, sl, r, WINDOW, BLOCK, MAX_MATCH,
                              screen_bytes, 256)
    before = mf.suffix_screen.launches
    got = mf.suffix_screen(words, so, sl, r, WINDOW, BLOCK, MAX_MATCH,
                           screen_bytes, 256, chunk=2)
    assert mf.suffix_screen.launches == before
    assert_equal(got, want)
    # A rejected neighbour still competes with s = -1, so every column,
    # halo and forward pad included, carries a first candidate: the kernel
    # has to reproduce that.
    assert bool((want[0] != 0).all())


@pytest.mark.parametrize("r,screen_bytes", [(8, 32), (16, 16), (32, 16),
                                            (4, 8)])
def test_a_pair_without_a_kernel_raises(r, screen_bytes):
    with pytest.raises(ValueError, match="no kernel"):
        mf.suffix_screen(*meta_inputs(), r, WINDOW, BLOCK, MAX_MATCH,
                         screen_bytes, 256)


@pytest.mark.parametrize("r,screen_bytes", PAIRS)
def test_an_unsupported_device_raises(r, screen_bytes):
    with pytest.raises(ValueError, match="unsupported device"):
        mf.suffix_screen(*meta_inputs(), r, WINDOW, BLOCK, MAX_MATCH,
                         screen_bytes, 256)


# ------------------------------------------------------------ the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda"


def check_kernel(words, so, sl, r, screen_bytes, window, block, restart,
                 chunk):
    """The kernel's outputs equal the plain version's, on the card, and
    the wrapper counted one launch a chunk of rows."""
    before = mf.suffix_screen.launches
    got = mf.suffix_screen(words, so, sl, r, window, block, MAX_MATCH,
                           screen_bytes, restart, chunk)
    torch.cuda.synchronize()
    assert mf.suffix_screen.launches == before + -(-words.shape[0] // chunk)
    want = mf.suffix_screen_w_chunked(words, so, sl, r, window, block,
                                      MAX_MATCH, screen_bytes, restart,
                                      dp.SCREEN_CHUNK)
    assert_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("chunk", [64, 2])
@pytest.mark.parametrize("restart", [0, 256])
@pytest.mark.parametrize("r,screen_bytes", PAIRS)
def test_kernel_equals_plain_small_geometry(card, r, screen_bytes, restart,
                                            chunk):
    check_kernel(*small_inputs(card), r, screen_bytes, WINDOW, BLOCK,
                 restart, chunk)


@pytest.fixture(scope="module")
def cell_layout(card):
    """The gzip6.archive cell's screen input: 2 x 16 MiB of corpus.mixed
    (the headline seeds of chip_smoke.py), 512 rows on the card."""
    from tpz_torch.utils.corpus import make_corpus

    datas = make_corpus([(16 << 20, 1000), (16 << 20, 1001)])
    span, so, sl, bl, _, bfinal, _ = (
        torch.from_numpy(a).to(card) if isinstance(a, np.ndarray) else a
        for a in dp.span_layout(datas))
    words = dp._zero_past_end(dp._make_words(span), bl, bfinal)
    return words, so, sl


@pytest.mark.card
@pytest.mark.parametrize("restart", [0, 16384])
@pytest.mark.parametrize("r,screen_bytes", PAIRS)
def test_kernel_equals_plain_cell_layout(cell_layout, r, screen_bytes,
                                         restart):
    assert cell_layout[0].shape == (512, mf.M_TOTAL)
    check_kernel(*cell_layout, r, screen_bytes, mf.WINDOW, mf.BLOCK, restart,
                 dp.SCREEN_CHUNK)


@pytest.mark.card
def test_a_pair_without_a_kernel_raises_on_the_card(card):
    before = mf.suffix_screen.launches
    with pytest.raises(ValueError, match="no kernel"):
        mf.suffix_screen(*small_inputs(card), 8, WINDOW, BLOCK, MAX_MATCH,
                         32, 256)
    assert mf.suffix_screen.launches == before


@pytest.mark.card
@pytest.mark.parametrize("level", [1, 6, 9])
def test_the_encode_on_the_card_runs_the_kernel(card, level):
    """A DEFLATE encode on the card screens through the kernel, one launch
    a chunk, and its streams equal the C++ oracle's."""
    from tpz_torch import oracle
    from tpz_torch.codecs.deflate import DeflateConfig

    datas = [corpus.mixed(300_000, seed=5), corpus.text(70_000, seed=6)]
    cfg = DeflateConfig(level=level)
    before = mf.suffix_screen.launches
    bodies = dp.compress_many(datas, cfg, card)
    assert mf.suffix_screen.launches == before + 1
    assert bodies == oracle.deflate_encode_many(datas, cfg.params_array())
