"""The last two TPU kernels' functions in the port, on the CPU: the greedy
reach walk (`greedy_parse`, `reach_walk`; the reference's greedy_parse
and _parse_pallas) and the interleaved spec-v3 walk
(`parse_extend_v3w_plain`, and the torch twin of its kernel,
`parse_extend_v3w_tokens_plain`; the reference's parse_extend_pallas_v3w),
each held against JAX's function (Pallas kernels in interpret mode) on the
same inputs made from a numpy seed. Everything compared is integer: the
tolerance is exact equality. The reach walk's tiled twin is in
test_torch_reach_tiles.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels import matchfinder as jmf
from tpz.kernels.parse import _parse_doubling, _parse_pallas
from tpz.kernels.parse import greedy_parse as jgreedy_parse
from tpz.kernels.parse import parse_extend_pallas_v3w
from tpz_torch.kernels import parse
from tpz_torch.utils import corpus

# The geometry of tests/test_kernels.py's v3w test: window 512, block
# 1024, three blocks with a ragged tail, restart 256.
WINDOW, BLOCK, NBLK, RESTART = 512, 1024, 3, 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain walk runs many tiny torch ops, for which intra-op threads
    only add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_steps():
    """The steps of tests/test_kernels.py's reach test, long jumps
    included."""
    rng = np.random.default_rng(2)
    step = rng.integers(1, 9, size=(3, 256)).astype(np.int32)
    step[rng.random(step.shape) < 0.1] = 100
    return step


def _screen(seed, tail=100):
    """JAX's v3 screen of corpus.mixed at the v3w test geometry: (pk1,
    pk2, cap_at [NB, BLOCK], words [NB, M] int32, block_len [NB]) numpy."""
    n = NBLK * BLOCK - tail
    span = np.zeros(WINDOW + NBLK * BLOCK + 512, np.uint8)
    span[WINDOW:WINDOW + n] = np.frombuffer(corpus.mixed(n, seed=seed),
                                            np.uint8)
    m = WINDOW + BLOCK + 512
    idx = np.arange(NBLK)[:, None] * BLOCK + np.arange(m)[None, :]
    words = jmf.words_at(jnp.asarray(span[idx].astype(np.int32)))
    span_off = jnp.asarray((np.arange(NBLK) * BLOCK).astype(np.int32))
    block_len = np.minimum(n - np.arange(NBLK) * BLOCK, BLOCK).astype(np.int32)
    pk1, pk2, cap_at = jmf.suffix_screen_w(
        words, span_off, jnp.int32(n), 8, WINDOW, BLOCK, 258, 16, RESTART)
    sl = slice(WINDOW, WINDOW + BLOCK)
    w32 = np.asarray(jax.lax.bitcast_convert_type(words, jnp.int32))
    return (np.asarray(pk1)[:, sl], np.asarray(pk2)[:, sl],
            np.asarray(cap_at)[:, sl], w32, block_len)


@pytest.fixture(scope="module", params=[False, True], ids=["greedy", "lazy"])
def v3w_case(request):
    """(lazy, inputs, JAX's v3w outputs in interpret mode)."""
    lazy = request.param
    pk1, pk2, cap_at, words, bl = _screen(321)
    want = parse_extend_pallas_v3w(
        pk1, pk2, words, bl[:, None], WINDOW, 258, 16, lazy=lazy,
        restart=RESTART, nblk=2, interpret=True)
    return lazy, (pk1, pk2, cap_at, words, bl), [np.asarray(x) for x in want]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_reach_walk_matches_pallas_and_doubling():
    step = _random_steps()
    s = jnp.asarray(step)
    want = np.asarray(_parse_pallas(s, interpret=True))
    assert np.array_equal(want > 0, np.asarray(_parse_doubling(s)) > 0)
    got = parse.reach_walk(_t(step))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reach_walk_takes_a_step_below_one_as_one():
    step = np.array([[0, -3, 2, 0, 5, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(parse.reach_walk(_t(step)).numpy(),
                                  [[1, 1, 1, 0, 1, 0, 0, 0]])


def _check_greedy_parse(mlen, bl):
    """All three outputs equal JAX's greedy_parse (its doubling), and the
    reach mask of their steps equals _parse_pallas in interpret mode."""
    zero = np.zeros_like(mlen)
    got = parse.greedy_parse(_t(mlen), _t(zero), _t(bl))
    want = jgreedy_parse(jnp.asarray(mlen), jnp.asarray(zero),
                         jnp.asarray(bl))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    step = np.where(mlen >= 3, mlen, 1).astype(np.int32)
    np.testing.assert_array_equal(
        parse.reach_walk(_t(step)).numpy(),
        np.asarray(_parse_pallas(jnp.asarray(step), interpret=True)))


def test_greedy_parse_matches_jax_on_random_steps():
    _check_greedy_parse(_random_steps(), np.array([256, 200, 17], np.int32))


def test_greedy_parse_matches_jax_on_v3_walk_lengths(v3w_case):
    """Real match lengths: the mlen of the v3 walk at the v3w geometry,
    ragged block lengths included."""
    _, inputs, want = v3w_case
    _check_greedy_parse(want[1], inputs[4])


def test_v3w_plain_matches_jax_v3w_everywhere(v3w_case):
    """visited, mlen and mdist equal JAX's v3w at every position, the
    zeros at and past each block's length included."""
    lazy, (pk1, pk2, _, words, bl), want = v3w_case
    got = parse.parse_extend_v3w_plain(
        _t(pk1), _t(pk2), _t(words), _t(bl), WINDOW, 258, 16, lazy=lazy,
        restart=RESTART)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[0] > 0).sum() > 1000
    past = np.arange(BLOCK)[None, :] >= bl[:, None]
    assert past.any() and not want[0][past].any()


def test_v3w_equals_v3z_at_n_extend_1_at_live_positions(v3w_case):
    """The v3w walk is the v3 walk with n_extend=1 (R4) given the screen's
    own cap_at: equal at every live position."""
    lazy, (pk1, pk2, cap_at, words, bl), want = v3w_case
    got = parse.parse_extend_v3z(
        _t(pk1), _t(pk2), _t(cap_at), _t(words), _t(bl), WINDOW, 258, 16,
        lazy=lazy, restart=RESTART, n_extend=1)
    live = np.arange(BLOCK)[None, :] < bl[:, None]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy() * live, w * live)


def test_v3w_wrapper_takes_the_plain_walk_on_the_cpu(v3w_case):
    lazy, (pk1, pk2, _, words, bl), want = v3w_case
    before = parse.parse_extend_v3w.launches
    got = parse.parse_extend_v3w(_t(pk1), _t(pk2), _t(words), _t(bl),
                                 WINDOW, lazy=lazy, restart=RESTART)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert parse.parse_extend_v3w.launches == before


@pytest.fixture(scope="module", params=[0, 512])
def restart(request):
    return request.param


@pytest.fixture(scope="module")
def restart_case(restart):
    """(inputs, JAX's v3w outputs in interpret mode) at one sub-walk per
    block (restart 0) or two (512), on a second input, greedy."""
    pk1, pk2, _, words, bl = _screen(99, tail=600)
    want = parse_extend_pallas_v3w(
        pk1, pk2, words, bl[:, None], WINDOW, 258, 16, restart=restart,
        nblk=2, interpret=True)
    return (pk1, pk2, words, bl), [np.asarray(x) for x in want]


def test_v3w_plain_matches_jax_at_other_restarts(restart, restart_case):
    """One sub-walk per block (restart 0) and two (512), on a second
    input, greedy."""
    (pk1, pk2, words, bl), want = restart_case
    got = parse.parse_extend_v3w_plain(
        _t(pk1), _t(pk2), _t(words), _t(bl), WINDOW, 258, 16,
        restart=restart)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------- the v3w form of the v3 walk kernel


@pytest.mark.parametrize("chunks", [1, 4, 32])
def test_v3w_tokens_twin_matches_jax_v3w(v3w_case, chunks):
    """The kernel's twin (the token at every position with v3w's derived
    cap and no candidate 2, then the chunk walks) equals JAX's v3w at
    every position, greedy and lazy, at 1, 4 and 32 chunk walks a
    sub-walk."""
    lazy, (pk1, pk2, _, words, bl), want = v3w_case
    got = parse.parse_extend_v3w_tokens_plain(
        _t(pk1), _t(pk2), _t(words), _t(bl), WINDOW, 258, 16, lazy=lazy,
        restart=RESTART, chunks=chunks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_v3w_tokens_twin_matches_jax_at_other_restarts(restart,
                                                       restart_case):
    (pk1, pk2, words, bl), want = restart_case
    got = parse.parse_extend_v3w_tokens_plain(
        _t(pk1), _t(pk2), _t(words), _t(bl), WINDOW, 258, 16,
        restart=restart, chunks=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_v3w_tokens_twin_equals_plain_v3w():
    """The twin equals the plain version on a third input with a short
    last block, greedy and lazy; its pk2 is never read (n_extend 1), so
    a pk2 of garbage changes nothing."""
    pk1, pk2, _, words, bl = _screen(7, tail=300)
    junk = np.random.default_rng(5).integers(0, 1 << 30, pk2.shape)
    for lazy in (False, True):
        want = parse.parse_extend_v3w_plain(
            _t(pk1), _t(pk2), _t(words), _t(bl), WINDOW, 258, 16,
            lazy=lazy, restart=RESTART)
        got = parse.parse_extend_v3w_tokens_plain(
            _t(pk1), _t(junk.astype(np.int32)), _t(words), _t(bl), WINDOW,
            258, 16, lazy=lazy, restart=RESTART)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_v3w_shared_memory_check():
    """The v3w wrapper's check before any launch: a sub-walk of 16,384
    positions (the gzip levels) or a whole 65,536-position row (restart
    0) fits a CUDA block's shared memory; a 131,072-position row does
    not, and raises ValueError rather than launching."""
    for restart in (16384, 65536):
        parse.check_parse_v3_restart(restart, "v3w parse walk")
    with pytest.raises(ValueError, match="v3w parse walk: restart=131072"):
        parse.check_parse_v3_restart(131072, "v3w parse walk")
    largest = max(r for r in range(100_000, 120_000)
                  if parse.parse_v3_shared_bytes(r) <= parse.SHARED_LIMIT)
    assert 108_000 < largest < 110_000
    with pytest.raises(ValueError, match="shared memory"):
        parse.check_parse_v3_restart(largest + 1)
