"""Stage times of one call, from CUDA events recorded at the program's
own stage hooks (a copy of `chip_smoke.stage_split`).

The program calls `stage_hook(name)` at each of its stage boundaries
(`kernels/deflate_pipeline.py`, `inflate_pipeline.py`,
`bzip2_pipeline.py`, `bzip2_walk.py`, `ibwt_walk.py`,
`codecs/gzip_codec.py`). The hook records a CUDA event and returns: it
does not synchronise, so the device keeps its queue. A stage's time is
the device clock between its event and the one before; a host stage, with
the device idle, reads the host's time.
"""

from __future__ import annotations


def stage_split(run) -> dict:
    """(milliseconds between the CUDA events recorded at each stage hook
    of run(hook), summed by stage name; run's result)."""
    import torch

    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    result = run(hook)
    torch.cuda.synchronize()
    split = {}
    for (_, prev), (name, ev) in zip(events, events[1:]):
        split[name] = split.get(name, 0.0) + prev.elapsed_time(ev)
    return split, result
