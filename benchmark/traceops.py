"""Arithmetic on a profiler's events, kept in memory: which device work a
stretch of host time launched, the union of its device intervals, its
kernel time, and the idle gaps between (the method of `chip_smoke.py`'s
`device_busy` and `missing_kernels`, PR 12).

The profiler places a session's device events against the host's clock
with an offset of its own, up to milliseconds (`trace_offset.py`), so a
device event's own time does not say which host stretch launched it. Its
correlation id does: the id of the runtime or driver call that launched
it. A stretch's device work is the device events whose ids are those of
the launch calls the host made inside the stretch.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

from torch.autograd import DeviceType

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op",) + HOST_LAUNCH_CATS
# Runtime and driver calls that put work on the device; every one of them
# launched inside a stretch has to have its device event in the trace.
LAUNCH_WORDS = ("LaunchKernel", "LaunchCooperativeKernel", "Memcpy", "Memset")


@dataclass(frozen=True)
class Event:
    name: str
    cat: str      # the profiler's activity type: "kernel", "cpu_op", ...
    ts: float     # start, microseconds
    dur: float    # microseconds
    corr: int     # correlation id

    @property
    def end(self) -> float:
        return self.ts + self.dur


def _kind(e, labels) -> str:
    """The profiler's activity type of a result event. Where torch does
    not give it (`activity_type` is newer than some versions), it is
    told from the device and the name: CUDA memcpy and memset events are
    named so, runtime calls begin with "cuda", driver calls with "cu",
    and annotations carry the labels the harness gave them."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name, gpu = e.name(), e.device_type() == DeviceType.CUDA
    if name in labels:
        return "gpu_user_annotation" if gpu else "user_annotation"
    if gpu:
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return ("cuda_runtime" if name.startswith("cuda") else
            "cuda_driver" if name.startswith("cu") else "cpu_op")


def from_profiler(prof, labels=()) -> list[Event]:
    """The events of a finished `torch.profiler.profile`, read from its
    results in memory (no trace file is written); `labels` are the
    names of the annotations the caller made."""
    return [Event(e.name(), _kind(e, labels), e.start_ns() / 1e3,
                  e.duration_ns() / 1e3, e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def span_of(events, label: str) -> tuple[float, float]:
    """[start, end] in microseconds of the host annotation `label`."""
    e = next(e for e in events
             if e.name == label and e.cat == "user_annotation")
    return e.ts, e.end


def _launch_calls(events, t0: float, t1: float) -> list[Event]:
    return [e for e in events if e.cat in HOST_LAUNCH_CATS
            and t0 <= e.ts <= t1
            and any(w in e.name for w in LAUNCH_WORDS)]


def launched(events, t0: float, t1: float) -> list[Event]:
    """The device events launched by calls the host made in [t0, t1]."""
    ids = {e.corr for e in _launch_calls(events, t0, t1)}
    return [e for e in events if e.cat in DEVICE_CATS and e.corr in ids]


def missing_launches(events, t0: float, t1: float) -> list[str]:
    """Names of the launch calls made in [t0, t1] whose device event the
    trace lacks: a stretch with any is no measurement of its device."""
    ids = {e.corr for e in events if e.cat in DEVICE_CATS}
    return [e.name for e in _launch_calls(events, t0, t1)
            if e.corr not in ids]


def busy_intervals(device_events) -> list[tuple[float, float]]:
    """The union of the events' intervals, as sorted disjoint pairs."""
    out = []
    for a, b in sorted((e.ts, e.end) for e in device_events):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_us(device_events) -> float:
    """Microseconds in which at least one of the events ran."""
    return sum(b - a for a, b in busy_intervals(device_events))


def kernel_us(device_events) -> float:
    """Summed durations of the kernels among the events."""
    return sum(e.dur for e in device_events if e.cat == "kernel")


def top_ops(device_events, k: int = 10) -> list:
    """[[name, seconds]] of the k device operations that took the most
    time, summed by name."""
    by = {}
    for e in device_events:
        by[e.name] = by.get(e.name, 0.0) + e.dur / 1e6
    return [[n[:160], s] for n, s in sorted(by.items(),
                                            key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, device_events, t0: float, t1: float,
              k: int = 10) -> list:
    """[[name, seconds]] of the k longest stretches of [t0, t1] in which
    none of `device_events` ran, each named by the host operation that
    overlaps it most, where that one covers half of it or more, else "no
    torch op" (Python, NumPy or the program's C++), and by the device
    operation that follows it."""
    busy = busy_intervals(device_events)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(max(a, t0), min(b, t1)) for a, b in zip(edges[::2], edges[1::2])]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:k]
    dev = sorted(device_events, key=lambda e: e.ts)
    starts = [e.ts for e in dev]
    host = [e for e in events if e.cat in HOST_CATS
            and e.end > t0 and e.ts < t1]
    out = []
    for a, b in gaps:
        best, over = "no torch op", (b - a) / 2
        for e in host:
            o = min(b, e.end) - max(a, e.ts)
            if o >= over:
                best, over = e.name, o
        i = bisect.bisect_left(starts, b)
        after = dev[i].name[:60] if i < len(dev) else "the stretch's end"
        out.append([f"{best[:60]}, before {after}", (b - a) / 1e6])
    return out
