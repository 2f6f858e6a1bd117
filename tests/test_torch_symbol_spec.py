"""The inflate symbol walk's kernel design (tpz_torch/csrc/symbol_walk.cu)
held against the plain walk and the JAX package on the CPU.

`symbol_walk_spec_plain` is the kernel's torch twin, vectorised over
chains and lanes: pass A decodes from guessed bit offsets (lane 0 from
the true body bit) and records each lane's first E token starts, pass B
carries lane k - 1 into lane k's range until the two walks meet (through
the whole range, the slow route, where they do not meet within E
tokens), the stitch composes the lanes in order, and pass C stores each
lane's confirmed range.
Its markers must equal `symbol_walk_plain`'s and JAX's `_symbol_walk_vz`
on the fixtures of test_torch_inflate.py (indexed and segmented layouts,
every block type, carried start positions, the corrupt stream) at 1, 2,
8 and 32 lanes, with E small enough (1, 2) to force the slow route, and
with end-bit hints that are wrong (0, and past the slice): the hint only
places the guesses. Markers are integers: the tolerance is exact
equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_inflate import (WALK_KEYS, _indexed_layout,  # noqa: F401
                                _segmented_layout, indexed_items,
                                one_torch_thread, segment_items)
from tpz.kernels import inflate_pipeline as jip
from tpz_torch.kernels import _build
from tpz_torch.kernels import inflate_pipeline as ip


def _corrupt(L):
    """The corrupt stream of test_torch_inflate.py: 40 flipped bits in
    the first entry's slice."""
    words = L["stream_words"].copy()
    u = words.view(np.uint32)
    rng = np.random.default_rng(5)
    for _ in range(40):
        u[0, int(rng.integers(10, 800))] ^= np.uint32(
            1 << int(rng.integers(0, 32)))
    return {**L, "stream_words": words}


@pytest.fixture(scope="module")
def layouts(indexed_items, segment_items):
    """Each route's layout, its walk arguments and the markers of the
    plain walk, which must equal JAX's."""
    out = {}
    for name, L in (("indexed", _indexed_layout(indexed_items[1])),
                    ("segmented", _segmented_layout(*segment_items[1:]))):
        for key, lay in ((name, L), (f"{name}-corrupt", _corrupt(L))):
            args = [torch.from_numpy(lay[k]) for k in WALK_KEYS]
            want = ip.symbol_walk_plain(*args).numpy()
            jax_want = np.asarray(jax.jit(jip._symbol_walk_vz)(
                *(jnp.asarray(lay[k]) for k in WALK_KEYS)))
            np.testing.assert_array_equal(want, jax_want, err_msg=key)
            out[key] = (lay, args, want)
    return out


def _twin(entry, lanes=32, records=32, hint="layout"):
    L, args, want = entry
    nb = len(L["out_len"])
    h = {"layout": torch.from_numpy(L["walk_end_bit"]), "none": None,
         "zero": torch.zeros(nb, dtype=torch.int32),
         "past": torch.full((nb,), 1 << 30, dtype=torch.int32)}[hint]
    got, stats = ip.symbol_walk_spec_plain(*args, walk_end_bit=h,
                                           lanes=lanes, records=records)
    np.testing.assert_array_equal(
        got.numpy(), want,
        err_msg=f"{lanes} lanes, {records} records, hint {hint}")
    return stats


@pytest.mark.parametrize("route,lanes", [
    ("indexed", 1), ("indexed", 2), ("indexed", 8), ("indexed", 32),
    ("segmented", 2), ("segmented", 8), ("segmented", 32)])
def test_twin_equals_plain_and_jax(layouts, route, lanes):
    met, through, serial = _twin(layouts[route], lanes)
    if lanes == 1:
        assert met == through == serial == 0
    if lanes == 32:
        assert met > through + serial


@pytest.mark.parametrize("route", ["indexed", "segmented"])
def test_twin_at_the_kernels_defaults(layouts, route):
    """SPEC_LANES lanes of SPEC_RECORDS records, as the kernel runs."""
    _twin(layouts[route], ip.SPEC_LANES, ip.SPEC_RECORDS)


@pytest.mark.parametrize("records", [1, 2])
@pytest.mark.parametrize("route", ["indexed", "segmented"])
def test_twin_slow_route(layouts, route, records):
    """With one or two records a lane, most lane boundaries meet too late
    and take the slow route; the markers do not change."""
    met, through, serial = _twin(layouts[route], 32, records)
    assert through + serial > met


@pytest.mark.parametrize("hint", ["none", "zero", "past"])
def test_twin_wrong_end_bit_hints(layouts, hint):
    """A missing or wrong hint (0, below every body bit; past the slice)
    spreads the guesses over the whole slice instead."""
    _twin(layouts["segmented"], 32, 32, hint)


@pytest.mark.parametrize("route", ["indexed", "segmented"])
def test_twin_on_corrupt_stream(layouts, route):
    """Flipped bits: the walk ends early on an invalid code or decodes
    garbage, the same for the twin as for the plain walk."""
    _twin(layouts[f"{route}-corrupt"], 32, 32)
    if route == "indexed":
        _twin(layouts[f"{route}-corrupt"], 8, 2)


def test_layout_walk_end_bit(layouts):
    """walk_end_bit is each chain's end bit in its slice: past its body
    bit for every chain the walk decodes, inside the slice."""
    for route in ("indexed", "segmented"):
        L = layouts[route][0]
        live = L["walk_out_len"] > L["start_pos"]
        sw_bits = L["stream_words"].shape[1] * 32
        assert (L["walk_end_bit"][live] > L["body_bit_local"][live]).all()
        assert (L["walk_end_bit"] <= sw_bits).all()


def test_shared_memory_bound():
    """A chain's tables, its 18,432-word slice and 32 lanes' records at
    the largest E fit one CUDA block."""
    sw = ip.SLICE_BYTES // 4
    assert ip.symbol_walk_shared_bytes(sw, 32, 64) <= _build.SHARED_LIMIT
    assert ip.symbol_walk_shared_bytes(sw) == 4 * (
        ip.TAB_WIDTH + sw + 2 * ip.SPEC_LANES * ip.SPEC_RECORDS)
