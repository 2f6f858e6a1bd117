#!/usr/bin/env python3
"""Where torch.profiler places a call's device events against the host's
clock, and what that does to chip_smoke.py's traced calls. The call is
chip_smoke.py's traced greedy_parse (#8's wrapper and its torch ops) on
the gzip headline's parse: 2 x 16 MiB of corpus.mixed (seeds 1000,
1001). Sessions alternate between no margin and chip_smoke's
(TRACE_MARGIN_S of calls before the traced call, of idle host time
after it).

    python3 trace_offset.py [--sessions 40] [--gap 2]

Prints the card's name and power limit, one line a session (the launch
to kernel offsets the trace gives, in microseconds: a kernel cannot
start before the host call that launched it, so a negative offset is
the trace's clock error; the traced call's wall ms; whether a kernel of
#8 that it launched is missing; the busy time of the device events
clipped to the host annotation, as chip_smoke.py measured it before,
and of those launched in it, as it does now), then a summary line for
each margin. Needs one NVIDIA GPU and the repository checkout around
it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import chip_smoke as cs


def clipped_busy_ms(events, t0_us: float, t1_us: float) -> float:
    """Busy ms of the trace's device events clipped to [t0_us, t1_us]."""
    spans = sorted(
        (max(float(e["ts"]), t0_us),
         min(float(e["ts"]) + float(e.get("dur", 0)), t1_us))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in cs.DEVICE_CATS)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > a and b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def session(fn, counters, margin_s: float) -> dict:
    events, wall_ms, (t0, t1) = cs.traced_session(fn, "greedy_parse",
                                                  counters, margin_s)
    host = {e["args"]["correlation"]: float(e["ts"]) for e in events
            if e.get("cat") in cs.HOST_LAUNCH_CATS
            and "correlation" in e.get("args", {})}
    kernels = cs.kernel_events(events)
    offsets = [float(k["ts"]) - host[k["args"]["correlation"]]
               for k in kernels
               if k.get("args", {}).get("correlation") in host]
    return {"margin_s": margin_s, "wall_ms": round(wall_ms, 4),
            "kernels": len(kernels),
            "missing": cs.missing_kernels(events, counters, t0, t1),
            "launch_to_kernel_us": [round(min(offsets), 1),
                                    round(max(offsets), 1)]
            if offsets else None,
            "clipped_busy_ms": round(clipped_busy_ms(events, t0, t1), 4),
            "launched_busy_ms": round(cs.device_busy(events, t0, t1)[0], 4)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=40)
    ap.add_argument("--gap", type=float, default=2.0,
                    help="seconds between sessions")
    a = ap.parse_args()

    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import parse

    smi = cs.phase_device()
    cs.phase_build()
    batch = cs.make_corpus([(cs.HEADLINE_BYTES, 1000 + i)
                            for i in range(2)])
    cfg = DeflateConfig(level=cs.LEVEL)
    inputs = cs.parse_inputs(batch, cfg, "cuda")
    _, mlen, mdist = parse.parse_extend_v3(*inputs, *cs._parse_args(cfg))
    bl = inputs[4]
    counters = {"reach": parse.reach_walk}
    runs = []
    for i in range(a.sessions):
        rec = session(lambda: parse.greedy_parse(mlen, mdist, bl), counters,
                      cs.TRACE_MARGIN_S if i % 2 else 0.0)
        runs.append(rec)
        cs.log("trace-offset", session=i, card=f"'{smi}'", **{
            k: json.dumps(v) for k, v in rec.items()})
        time.sleep(a.gap)
    for m in sorted({r["margin_s"] for r in runs}):
        rs = [r for r in runs if r["margin_s"] == m]
        lows = [r["launch_to_kernel_us"][0] for r in rs
                if r["launch_to_kernel_us"]]
        cs.log("trace-offset-summary", margin_s=m, sessions=len(rs),
               missing_a_kernel=sum(bool(r["missing"]) for r in rs),
               clipped_busy_zero=sum(r["clipped_busy_ms"] <= 0 for r in rs),
               launched_busy_zero=sum(r["launched_busy_ms"] <= 0 for r in rs),
               min_launch_to_kernel_us=min(lows) if lows else None,
               median_wall_ms=statistics.median(r["wall_ms"] for r in rs),
               card=f"'{smi}'")
    return 0


if __name__ == "__main__":
    sys.exit(main())
