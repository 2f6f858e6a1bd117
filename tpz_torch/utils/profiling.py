"""Tracing hooks (port of tpz/utils/profiling.py).

`trace` captures a torch.profiler trace of the enclosed block and writes
it as a chrome trace (open it in Perfetto or chrome://tracing);
`annotate` names a region that shows up in that timeline. The reference
reads its trace directory from TPZ_TRACE_DIR; the port reads no
environment variable, so the caller names the directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Profile the enclosed block: CPU activity, and the card's kernels,
    copies and sets when `device` is a CUDA device. On exit the trace is
    written to log_dir/trace-<pid>-<ns>.json. Yields the profiler.

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


def annotate(name: str):
    """Named region that shows up in profiler timelines."""
    return torch.profiler.record_function(name)
