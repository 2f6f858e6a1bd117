#!/usr/bin/env python3
"""Time the iBWT kernels (tpz_torch/csrc/ibwt_walk.cu) at several splitter
strides on the bzip2 decode headline of chip_smoke.py: 2 x 16 MiB of
corpus.mixed (seeds 1000, 1001) encoded by the oracle at level 9, last
columns from the symbol-walk kernel and the decode's own expansion and
LF sort. Every stride must give the same bytes and flags.

    python3 ibwt_stride.py

Prints the card's name and power limit, then one line per stride: mean
milliseconds of 5 warm calls (CUDA events). Needs one NVIDIA GPU and the
repository checkout around it.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as cs

STRIDES = (2048, 512, 256, 128, 64)


def main() -> int:
    from tpz_torch import oracle
    from tpz_torch.kernels import bzip2_walk as bw
    from tpz_torch.kernels import ibwt_walk as iw

    smi = cs.phase_device()
    cs.phase_build()
    batch = cs.make_corpus([(cs.HEADLINE_BYTES, 1000 + i)
                            for i in range(cs.HEADLINE_BUFFERS)])
    blobs = [oracle.bzip2_encode(d, cs.BZIP2_LEVEL) for d in batch]
    t, N, S = cs.bzip2_layout(blobs)
    recs, meta = bw.bzip2_walk(*(t[k] for k in bw.WALK_ARGS), S)
    args = cs.ibwt_inputs(t, recs, meta, N)
    del recs, t
    want = None
    for seg in STRIDES:
        got, _ = cs.timed(lambda: iw.ibwt(*args, seg))
        _, ms = cs.timed(lambda: iw.ibwt(*args, seg), 5)
        if want is None:
            want = got
        elif not (torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1])):
            raise RuntimeError(f"ibwt at seg {seg} differs from seg "
                               f"{STRIDES[0]}")
        cs.log("ibwt-stride", seg=seg, blocks=meta.shape[0],
               nodes=int(args[2].long().sum()),
               chains_per_block=iw.chains_per_block(N, seg),
               ms=f"{ms:.3f}", card=f"'{smi}'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
