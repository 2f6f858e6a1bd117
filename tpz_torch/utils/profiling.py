"""The port's tracing: named ranges on torch.profiler's clock.

`span(name)` names a region `tpz_torch.<name>`; `stage(layer, name,
hook)` is the span `tpz_torch.<layer>.<name>` of one pipeline stage, and
the only way a stage boundary is marked: on a clean exit it calls
`hook(name)`, the stage hook the pipelines take (`_nohook` where the
caller times no stage). Under a running profiler the ranges appear in its
events beside the kernels they launched; with none running a span is one
check of the profiler's state and enters nothing. Spans never
synchronise the device.

`trace` captures a torch.profiler trace of the enclosed block, the
program's ranges included, and writes it as a chrome trace (open it in
Perfetto or chrome://tracing). The reference reads its trace directory
from TPZ_TRACE_DIR; the port reads no environment variable, so the
caller names the directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

PREFIX = "tpz_torch."
# A profiler range costs about 13 us to enter and leave even with no
# profiler running; this check costs well under one.
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _nohook(stage: str) -> None:
    """The stage hook of a caller that times no stage."""


def span(name: str):
    """The profiler range `tpz_torch.<name>` around a `with` block, or a
    shared null context when no profiler is running."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


class _Stage:
    """A stage's range; on a clean exit, after the range closes, the
    stage's hook."""

    __slots__ = ("_range", "_hook", "_name")

    def __init__(self, rng, hook, name: str):
        self._range, self._hook, self._name = rng, hook, name

    def __enter__(self):
        self._range.__enter__()

    def __exit__(self, typ, value, tb):
        self._range.__exit__(typ, value, tb)
        if typ is None:
            self._hook(self._name)


def stage(layer: str, name: str, hook=_nohook):
    """The span `tpz_torch.<layer>.<name>` of the code between the
    previous stage boundary and this one; on a clean exit it calls
    hook(name). A stage whose code crosses a function boundary is one
    such span and, before it, plain spans of the same name."""
    rng = (torch.profiler.record_function(f"{PREFIX}{layer}.{name}")
           if _profiling() else _OFF)
    return rng if hook is _nohook else _Stage(rng, hook, name)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the enclosed block: CPU activity and the program's spans,
    and the card's kernels, copies and sets when `device` is a CUDA
    device. On exit the trace is written to
    log_dir/trace-<pid>-<ns>.json. Yields the profiler.

        with profiling.trace("build/trace"):
            tpz_torch.api.compress_many(bufs, "gzip")
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
