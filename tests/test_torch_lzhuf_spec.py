"""The LZHUF token walk's kernel design (tpz_torch/csrc/lzhuf_walk.cu)
held against the plain walk and the JAX package on the CPU.

`lzhuf_walk_spec_plain` is the kernel's torch twin, vectorised over
segments, lanes and phases: pass A walks each lane's range from every bit
of the first D at its guess (phase walks), the stitch composes the lanes
in order (a lookup of the phase walk that started where the true walk
enters the lane; the slow route, a walk through the range, where it
enters D bits or more past the guess), and pass C stores each lane's
range from its true entry (lane 0 from the body bit and the carried
match's output position); table rows are read as the kernel stages
them, narrowed to 16 bits. Its markers must equal `lzhuf_walk_plain`'s
and JAX's `_walk_vz` on the streams of test_torch_lzhuf_decode.py (lh5
and lh7, 16 KiB segments with split-match carries, constant-code blocks)
and on a corrupt lh5 body, at several lanes x phases pairs, with D small
enough (1, 2) to force the slow route, and with end-bit hints that are
missing or wrong (0, and past the slice): the hint only places the
guesses. Markers are integers: the tolerance is exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lzhuf_decode import (WALK_CASES, WALK_KEYS,  # noqa: F401
                                     _bodies, _layout, one_torch_thread)
from tpz.kernels import lzhuf_walk as jlw
from tpz_torch import oracle
from tpz_torch.kernels import _build
from tpz_torch.kernels import lzhuf_walk as lw
from tpz_torch.utils import corpus

SEG_OUT = 1 << 14


def _corrupt_case():
    """An lh5 body with bits flipped in the middle of its token stream
    (after the block header): the walk decodes other tokens, the same for
    every version. The indexer ran on the clean body, as it would on a
    stream whose damage it cannot see."""
    data = corpus.text(24_000, seed=21)
    body = oracle.lzhuf_encode(data, 13, 16)
    L = _layout([(body, len(data))], 13, SEG_OUT)
    words = L["stream_words"].copy()
    u = words.view(np.uint32)
    rng = np.random.default_rng(7)
    for s in range(u.shape[0]):
        lo, hi = int(L["body_bit_local"][s]), int(L["walk_end_bit"][s])
        for _ in range(6):
            bit = int(rng.integers(lo + (hi - lo) // 4, hi))
            u[s, bit >> 5] ^= np.uint32(1 << (31 - (bit & 31)))
    return {**L, "stream_words": words}


@pytest.fixture(scope="module")
def layouts():
    """Each case's layout, its walk arguments and the plain walk's
    markers, which must equal JAX's _walk_vz."""
    out = {}
    cases = {name: _layout(_bodies(datas, bits), bits, SEG_OUT)
             for name, (bits, datas) in WALK_CASES.items()}
    cases["lh5-corrupt"] = _corrupt_case()
    for name, L in cases.items():
        args = [torch.from_numpy(L[k]) for k in WALK_KEYS]
        want = lw.lzhuf_walk_plain(*args).numpy()
        jax_want = np.asarray(jax.jit(jlw._walk_vz)(
            *(jnp.asarray(L[k]) for k in WALK_KEYS)))
        np.testing.assert_array_equal(want, jax_want, err_msg=name)
        out[name] = (L, args, want)
    return out


def _twin(entry, lanes, phases, hint="layout"):
    L, args, want = entry
    nb = len(L["out_len"])
    h = {"layout": torch.from_numpy(L["walk_end_bit"]), "none": None,
         "zero": torch.zeros(nb, dtype=torch.int32),
         "past": torch.full((nb,), 1 << 30, dtype=torch.int32)}[hint]
    got, stats = lw.lzhuf_walk_spec_plain(*args, walk_end_bit=h,
                                          lanes=lanes, phases=phases)
    np.testing.assert_array_equal(
        got.numpy(), want,
        err_msg=f"{lanes} lanes, {phases} phases, hint {hint}")
    return stats


@pytest.mark.parametrize("case,lanes,phases", [
    ("lh5-text", 8, 32), ("lh5-text", 32, 8), ("lh7-mixed", 8, 32)])
def test_twin_equals_plain_and_jax(layouts, case, lanes, phases):
    """Lanes x phases pairs on a multi-segment lh5 stream and an lh7
    stream with level-2 codes (three pairs with the slow route's below);
    both carry split matches into later segments (start_pos > 0). Every
    lane of every segment is resolved by one route or the other."""
    L = layouts[case][0]
    assert len(L["out_len"]) >= 3 and (L["carry_len"] > 0).any()
    direct, serial, far = _twin(layouts[case], lanes, phases)
    assert direct + serial == len(L["out_len"]) * lanes
    assert far < 64
    if phases == 32:
        # The true walk enters within 32 bits of every guess here.
        assert serial == 0 and far < 32


def test_twin_at_the_kernels_defaults(layouts):
    """SPEC_LANES lanes of SPEC_PHASES phase walks, as the kernel runs."""
    _twin(layouts["lh7-mixed"], lw.SPEC_LANES, lw.SPEC_PHASES)


@pytest.mark.parametrize("phases", [1, 2])
def test_twin_slow_route(layouts, phases):
    """With one or two phase walks a lane, most true entries fall past
    them and take the slow route; the markers do not change."""
    direct, serial, _ = _twin(layouts["lh5-text"], 16, phases)
    assert serial > direct


@pytest.mark.parametrize("hint", ["none", "zero", "past"])
def test_twin_wrong_end_bit_hints(layouts, hint):
    """A missing or wrong hint (0, below every body bit; past the slice)
    spreads the guesses over the whole slice instead: lanes past the
    stream's end walk the slice's zero padding until their range or the
    segment's output count ends."""
    _twin(layouts["lh5-text"], 128, 8, hint)


def test_twin_constant_code_blocks(layouts):
    """Blocks whose c or p table is one 0-bit entry: tokens that read no
    bits still move the output, so every walk ends."""
    _twin(layouts["lh5-constant-codes"], 16, 4)
    _twin(layouts["lh5-constant-codes"], 16, 4, "none")


@pytest.mark.parametrize("lanes,phases", [(32, 8), (16, 4)])
def test_twin_on_corrupt_body(layouts, lanes, phases):
    """Flipped bits: the walk decodes other tokens (LZHUF has no invalid
    code and no checksum), the same for the twin as for the plain walk."""
    _twin(layouts["lh5-corrupt"], lanes, phases)


def test_twin_on_wide_tables(layouts):
    """A table row with an entry that does not fit 16 bits is read from
    global memory by the kernel, unnarrowed; the twin does the same and
    the markers do not change (the entry is never reached)."""
    L, args, want = layouts["lh5-text"]
    tab = args[4].clone()
    tab[:, lw.TW - 1] = 1 << 20
    got, _ = lw.lzhuf_walk_spec_plain(
        *args[:4], tab, walk_end_bit=torch.from_numpy(L["walk_end_bit"]),
        lanes=16, phases=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_layout_walk_end_bit(layouts):
    """walk_end_bit is each segment's end bit in its slice: past its body
    bit, inside the slice, and equal to the indexer's end bits."""
    for name, bits in (("lh5-text", 13), ("lh7-mixed", 16)):
        L = layouts[name][0]
        sw_bits = L["stream_words"].shape[1] * 32
        assert (L["walk_end_bit"] > L["body_bit_local"]).all()
        assert (L["walk_end_bit"] <= sw_bits).all()
        body, n = _bodies(WALK_CASES[name][1], bits)[0]
        idx = oracle.lzhuf_index(body, n, bits, seg_out=SEG_OUT)
        np.testing.assert_array_equal(
            L["walk_end_bit"][:len(idx["end_bits"])],
            idx["end_bits"] - idx["seg_bits"] // 8 * 8)


def test_shared_memory_bound():
    """The default lanes and phases with the layout's whole slice staged
    fit a CUDA block, and so do the most threads a block holds at 32
    phases."""
    sw = lw.SLICE_BYTES // 4
    need = lw.shared_bytes()
    assert need == lw.shared_bytes(sw) == 2 * lw.TW + 4 * sw + 8 \
        * lw.SPEC_LANES * lw.SPEC_PHASES + 4 * (4 * lw.SPEC_LANES + 1)
    assert lw.SPEC_LANES * lw.SPEC_PHASES <= 1024
    assert need <= _build.SHARED_LIMIT
    assert lw.shared_bytes(sw, 32, 32) <= _build.SHARED_LIMIT
