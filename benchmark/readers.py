"""What the metric readers in `metrics/` share. A reader is
`read(record) -> number or None`; None means it found nothing to read in
this run, and the metric is left out of the line.

The record (harness.run) holds "cell", "config" and "traffic" (the
parsed entry and files), "entry" ("compress_many" or "decompress_many"),
"setup_s", "window" (seconds, latencies_s, requests, plain_bytes,
stored_bytes, stored_plain_bytes) and, in a traced run, "stages" (a dict
of stage milliseconds for each hooked request), "stage_walls_s" (each of
those requests' wall time through the api entry, run just before it)
and "profile" (events, t0 and t1 of the profiled requests in
microseconds, the device events they launched, complete, least_bytes,
hbm_bytes_per_s).
"""

from __future__ import annotations

import statistics

from benchmark import traceops

ENCODE, DECODE = "compress_many", "decompress_many"


def rate_MBps(rec, entry: str):
    """Plaintext MB of every request the window completed, over the
    window's seconds, in cells that drive `entry`."""
    if rec["entry"] != entry:
        return None
    w = rec["window"]
    return w["plain_bytes"] / w["seconds"] / 1e6


def p95_ms(rec, entry: str):
    """The 95th percentile of the window's request latencies, ms."""
    lat = rec["window"]["latencies_s"]
    if rec["entry"] != entry or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3


def stage_ms(rec, names):
    """The median over the hooked requests of the summed time of the
    named stages, ms; None where no request passed one of them."""
    splits = rec.get("stages") or []
    if not any(n in s for s in splits for n in names):
        return None
    return statistics.median(sum(s.get(n, 0.0) for n in names)
                             for s in splits)


def self_ms(rec, entry: str):
    """The median, over the requests of the hooked rotation, of a
    request's wall time through its api entry less the summed stage
    times of the same request through the hooked entry, run right after
    it: what the entry and its codec do outside the program's stages
    (the framing and trailers among it), ms."""
    splits = rec.get("stages")
    if rec["entry"] != entry or not splits:
        return None
    return statistics.median(w * 1e3 - sum(s.values()) for w, s in
                             zip(rec["stage_walls_s"], splits))


def idle_pct(rec, entry: str):
    """100 x (1 - the union of the device intervals the profiled requests
    launched / their wall time)."""
    p = rec.get("profile")
    if rec["entry"] != entry or not p or not p["complete"]:
        return None
    return 100.0 * (1.0 - traceops.busy_us(p["device"]) / (p["t1"] - p["t0"]))


def roofline_pct(rec, entry: str):
    """100 x the least time of the profiled requests' work (their bytes
    in and out over the card's published bandwidth) / the summed time of
    every kernel they launched."""
    p = rec.get("profile")
    if (rec["entry"] != entry or not p or not p["complete"]
            or not p.get("hbm_bytes_per_s")):
        return None
    k_us = traceops.kernel_us(p["device"])
    if k_us <= 0:
        return None
    return 100.0 * (p["least_bytes"] / p["hbm_bytes_per_s"]) / (k_us / 1e6)
