"""The program's own spans in the profiled rotation: which request each
belongs to, where the device idled inside a request, and which device
work a span launched.

The port (`tpz_torch/utils/profiling.py`) names each api call
`tpz_torch.api.<entry>` and each stage and finer step under it
`tpz_torch.<layer>.<name>`. The profiler records them as user
annotations, or as `cpu_op` where torch gives no activity type
(`traceops._kind` tells annotations apart only by the harness's own
labels). A request is an outermost api span inside the harness's
profiled range; its spans are the program's spans inside it.

Spans are on the host's clock; the profiler places a session's device
events against it with an offset of its own. They are put on the host
clock by the session's shift: the smallest non-negative shift that
leaves no device event starting before the launch call whose
correlation id it carries. Which device work a span launched is told by
correlation id alone (`traceops.launched`), whatever the shift.

Each reading is the median over the profiled requests of a per-request
value, and None where the profile is incomplete, where the program
emitted no spans (a build without them), or where no request holds the
spans read.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, replace

from benchmark import traceops

PREFIX = "tpz_torch."
API = PREFIX + "api."
SPAN_CATS = ("user_annotation", "cpu_op")
# The key of idle_by_span for device-idle time that no span below the
# api span covers.
UNSPANNED = "(unspanned)"


def program_spans(events) -> list:
    """The program's spans among a profile's events."""
    return [e for e in events
            if e.cat in SPAN_CATS and e.name.startswith(PREFIX)]


def _is_device(e) -> bool:
    """A device event; on a torch without activity types the device side
    of a program span reads as a kernel (`traceops._kind`), and is not
    one."""
    return e.cat in traceops.DEVICE_CATS and not e.name.startswith(PREFIX)


def launched(events, t0: float, t1: float) -> list:
    """The device events launched by calls the host made in [t0, t1]."""
    return [e for e in traceops.launched(events, t0, t1) if _is_device(e)]


def shift_us(events) -> float:
    """The session's shift of its device events onto the host clock, us."""
    launch = {e.corr: e.ts for e in events
              if e.cat in traceops.HOST_LAUNCH_CATS}
    early = [launch[e.corr] - e.ts for e in events
             if _is_device(e) and e.corr in launch]
    return max([0.0] + early)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


@dataclass(frozen=True)
class Request:
    """One profiled api call: its span, the program's spans inside it,
    the device events it launched (on the host clock), and the session's
    events."""

    api: traceops.Event
    spans: list
    device: list
    events: list

    @property
    def idle(self) -> list:
        """The stretches of the api span in which none of the request's
        device events ran, as sorted disjoint pairs (us)."""
        t0, t1 = self.api.ts, self.api.end
        busy = _union((max(e.ts, t0), min(e.end, t1)) for e in self.device
                      if e.end > t0 and e.ts < t1)
        edges = [t0] + [x for ab in busy for x in ab] + [t1]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def named(self, names) -> list:
        full = {PREFIX + n for n in names}
        return [s for s in self.spans if s.name in full]


def requests(profile) -> list | None:
    """The profiled requests, in order; None where the profile is missing
    or incomplete, or holds no api span in its profiled range."""
    if not profile or not profile["complete"]:
        return None
    events = profile["events"]
    spans = program_spans(events)
    t0, t1 = profile["t0"], profile["t1"]
    apis = sorted((s for s in spans if s.name.startswith(API)
                   and t0 <= s.ts and s.end <= t1), key=lambda s: s.ts)
    outer = []
    for s in apis:
        if not outer or s.ts >= outer[-1].end:
            outer.append(s)
    if not outer:
        return None
    shift = shift_us(events)
    return [Request(a, [s for s in spans if s is not a
                        and a.ts <= s.ts and s.end <= a.end],
                    [replace(e, ts=e.ts + shift)
                     for e in launched(events, a.ts, a.end)],
                    events)
            for a in outer]


def per_request(rec, value, entry: str | None = None):
    """The median over the profiled requests of value(request), or None
    (see the module docstring); requests for which value gives None are
    left out. With `entry`, None in cells that drive another entry."""
    if entry is not None and rec["entry"] != entry:
        return None
    reqs = requests(rec.get("profile"))
    if not reqs:
        return None
    vals = [v for v in map(value, reqs) if v is not None]
    return statistics.median(vals) if vals else None


def span_ms(rec, names, entry: str | None = None):
    """A request's time inside the named spans (their union), ms; requests
    without one are left out."""
    def value(r):
        spans = r.named(names)
        return _length(_union((s.ts, s.end) for s in spans)) / 1e3 \
            if spans else None
    return per_request(rec, value, entry)


def count(rec, name: str, entry: str | None = None):
    """The spans named `name` in a request."""
    return per_request(rec, lambda r: len(r.named([name])), entry)


def kernel_ms(rec, name: str, entry: str | None = None):
    """The summed time of the kernels that calls inside the spans named
    `name` launched, ms a request; requests without one are left out."""
    def value(r):
        spans = r.named([name])
        if not spans:
            return None
        return sum(traceops.kernel_us(launched(r.events, s.ts, s.end))
                   for s in spans) / 1e3
    return per_request(rec, value, entry)


def idle_by_span(r: Request) -> dict:
    """{span name (without the prefix): us of the request's device-idle
    time in which that span is the innermost of the program's spans
    below the api span}, with UNSPANNED for the idle time none covers."""
    cuts = sorted({x for s in r.spans for x in (s.ts, s.end)})
    out = {}
    for a, b in r.idle:
        pts = [a] + cuts[bisect.bisect_right(cuts, a):
                         bisect.bisect_left(cuts, b)] + [b]
        for x, y in zip(pts, pts[1:]):
            mid = (x + y) / 2
            inner = [s for s in r.spans if s.ts <= mid < s.end]
            name = (min(inner, key=lambda s: s.dur).name[len(PREFIX):]
                    if inner else UNSPANNED)
            out[name] = out.get(name, 0.0) + (y - x)
    return out


def unspanned_ms(rec, entry: str):
    """A request's device-idle time that no program span below its api
    span covers: host work the spans do not name, ms."""
    return per_request(
        rec, lambda r: idle_by_span(r).get(UNSPANNED, 0.0) / 1e3, entry)
