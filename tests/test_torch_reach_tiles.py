"""The tiled design of the greedy reach walk (#8) on the CPU: its torch
twin `parse.reach_tiles_plain` (tiles walked from their starts by chunk
walks, exits from the int32 steps, the stitch across tiles, as
tpz_torch/csrc/reach_walk.cu does it) held against the pointer doubling
`_reach_doubling` and JAX's `_parse_doubling`, and where N % 128 == 0
against JAX's `_parse_pallas` in interpret mode, at tiles of 32, 64 and
1,024 positions. Inputs are made from a numpy seed; the outputs are
masks, so the tolerance is exact equality.

JAX's walks take p + step[p] as it is: a step of 0 would never end and a
step near 2^31 overflows. The port counts a step below 1 as 1 and ends
the walk at any step at or past N - p, so JAX is given the steps clipped
to [1, N], which have the same walk."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpz.kernels.parse import _parse_doubling, _parse_pallas
from tpz_torch.kernels import parse

TILES = (32, 64, 1024)
N = 2048


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The twin runs many tiny torch ops, for which intra-op threads only
    add overhead (and contend with the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random(rng, nb=3, n=N):
    return rng.integers(1, 259, size=(nb, n))


def _never_meeting(rng):
    """Steps of 2 after a 1 at position 0: the true walk visits the odd
    positions, every tile's guessed walk (from an even start) the even
    ones, so no tile's walks meet; row 1 mixes such runs with random
    steps."""
    s = np.full((2, N), 2)
    s[:, 0] = 1
    s[1, N // 2:] = rng.integers(1, 9, size=N // 2)
    return s


def _skipping(rng):
    """Steps longer than whole tiles of 32, 64 and 1,024 positions: a tile
    the true walk jumps over keeps none of its guessed marks."""
    s = rng.integers(1, 9, size=(3, N))
    s[0, 3] = 100
    s[1, 0] = 1100
    s[1, 1100] = 1
    s[2, ::97] = 700
    return s


def _below_one(rng):
    """Steps of 0 and below, which count as 1, between short ones."""
    return rng.integers(-6, 4, size=(3, N))


def _past_end(rng):
    """Steps at and far past N - p, up to 2^31 - 1: each ends the walk."""
    s = rng.integers(1, 40, size=(3, N))
    s[0, 40] = N
    s[1, 33] = 2**31 - 1
    s[2, :] = 2**31 - 1
    return s


def _ragged(rng):
    """N = 2,011: a multiple of no tile (nor of 128)."""
    return _random(rng, 2, 2011)


def _one_row(rng):
    return _random(rng, 1)


def _wide(rng):
    """N = 70,016 with steps of 65,535-66,000 that land inside the row: a
    tile's exit comes from the int32 step, which a 16-bit code would
    cut."""
    s = _random(rng, 2, 70016)
    s[0, 0] = 65536
    s[1, :8] = [1, 65535, 1, 1, 1, 1, 1, 1]
    s[1, 65536:65600] = 66000
    return s


CASES = {"random": _random, "never_meeting": _never_meeting,
         "skipping": _skipping, "below_one": _below_one,
         "past_end": _past_end, "ragged": _ragged, "one_row": _one_row,
         "wide": _wide}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(steps [NB, N] int32, the doubling's mask, JAX's masks), each
    computed once for all tiles."""
    step = CASES[name](np.random.default_rng(sorted(CASES).index(name)))
    step = step.astype(np.int32)
    want = parse._reach_doubling(
        torch.clamp(torch.from_numpy(step).long(), min=1)).numpy()
    n = step.shape[1]
    clipped = jnp.asarray(np.clip(step, 1, n))
    jax_masks = [np.asarray(_parse_doubling(clipped)) > 0]
    if n % 128 == 0:
        jax_masks.append(np.asarray(_parse_pallas(clipped, interpret=True))
                         > 0)
    return step, want, jax_masks


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_reach_tiles_match_doubling_and_jax(name, tile):
    step, want, jax_masks = _case(name)
    got = parse.reach_tiles_plain(torch.from_numpy(step), tile)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    for mask in jax_masks:
        np.testing.assert_array_equal(got.numpy(), mask)
    assert len(jax_masks) == (2 if step.shape[1] % 128 == 0 else 1)


def test_never_meeting_row_walks_through_every_tile():
    """The case the stitch handles slowly: the true walk's odd positions
    and no even one past 0, at every tile size."""
    step, want, _ = _case("never_meeting")
    assert want[0, 1::2].all() and not want[0, 2::2].any()
    for tile in TILES:
        got = parse.reach_tiles_plain(torch.from_numpy(step[:1]), tile)
        np.testing.assert_array_equal(got.numpy(), want[:1])


def test_reach_tile_is_one_the_kernel_takes():
    """The kernel's tile is a multiple of 32 whose cut steps fit 16 bits
    (the wrapper raises for any other before a launch)."""
    tile = parse.REACH_TILE
    assert tile % 32 == 0 and 32 <= tile <= 32768
