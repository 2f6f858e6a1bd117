#!/usr/bin/env python3
"""Time the LZHUF token walk kernel (tpz_torch/csrc/lzhuf_walk.cu) at
several lanes x phase-walks pairs on the lh5 decode headline of
chip_smoke.py: the first 16 MiB buffer of corpus.mixed (seed 1000),
encoded by the oracle at lh5 (max_chain 16) and laid out as the decode's
first dispatch (512 segments), with the layout's end-bit hint. Every pair
must give the plain walk's markers (run on host copies of the inputs).

    python3 lzhuf_lanes.py

Prints the card's name and power limit, then one line per pair: mean
milliseconds of 5 warm calls (CUDA events), the lane boundaries resolved
by a phase walk and by the slow route, the largest entry offset past a
guess, shared bytes a block and blocks resident per SM. Needs one NVIDIA
GPU and the repository checkout around it.
"""

from __future__ import annotations

import sys

import chip_smoke as cs

PAIRS = ((32, 32), (48, 21), (64, 16), (128, 8))


def main() -> int:
    from tpz_torch import oracle
    from tpz_torch.kernels import lzhuf_pipeline as lp
    from tpz_torch.kernels import lzhuf_walk as lw

    smi = cs.phase_device()
    cs.phase_build()
    data = cs.make_corpus([(cs.HEADLINE_BYTES, 1000)])[0]
    t = cs.lzhuf_walk_inputs(
        oracle.lzhuf_encode(data, cs._dict_bits(cs.LZHUF_METHOD),
                            lp.MAX_CHAIN), len(data), cs.LZHUF_METHOD)
    args, hint = lw._walk_args(t), t["walk_end_bit"]
    want = cs.on_host(lw.lzhuf_walk_plain, *args)
    sw = args[0].shape[1]
    saved = lw.SPEC_LANES, lw.SPEC_PHASES
    try:
        for lw.SPEC_LANES, lw.SPEC_PHASES in PAIRS:
            got, _ = cs.timed(lambda: lw.lzhuf_walk(*args, walk_end_bit=hint))
            stats = lw.lzhuf_walk.last_stats.tolist()
            _, ms = cs.timed(lambda: lw.lzhuf_walk(*args, walk_end_bit=hint),
                             5)
            err = int((got.long() - want.long()).abs().max())
            if err:
                raise RuntimeError(f"lzhuf walk at {lw.SPEC_LANES} x "
                                   f"{lw.SPEC_PHASES} disagrees with plain: "
                                   f"{err}")
            cs.log("lzhuf-lanes", lanes=lw.SPEC_LANES,
                   phases=lw.SPEC_PHASES, segments=args[0].shape[0],
                   ms=f"{ms:.4f}", direct_slow_far=stats,
                   shared_bytes=lw.shared_bytes(sw),
                   blocks_per_sm=lw.occupancy(sw), card=f"'{smi}'")
    finally:
        lw.SPEC_LANES, lw.SPEC_PHASES = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
