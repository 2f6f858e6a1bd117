"""Structured run reports (port of tpz/utils/metrics.py): bytes in and
out, ratio, throughput, per-stage timings and scaling efficiency, as one
JSON object with the reference's keys. `RunReport.backend` holds the
torch device the run used ("cuda", "cpu", ...).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class RunReport:
    codec: str = ""
    backend: str = ""
    bytes_in: int = 0
    bytes_out: int = 0
    seconds: float = 0.0
    stages: dict = field(default_factory=dict)
    devices: int = 1
    hosts: int = 1

    @property
    def ratio(self) -> float:
        return self.bytes_out / self.bytes_in if self.bytes_in else 0.0

    @property
    def gbps(self) -> float:
        return self.bytes_in / self.seconds / 1e9 if self.seconds else 0.0

    def to_json(self) -> str:
        return json.dumps({
            "codec": self.codec, "backend": self.backend,
            "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
            "ratio": round(self.ratio, 4), "seconds": round(self.seconds, 4),
            "gb_per_s": round(self.gbps, 4),
            "stages_s": {k: round(v, 4) for k, v in self.stages.items()},
            "devices": self.devices, "hosts": self.hosts,
        })


@contextmanager
def timed_stage(report: RunReport, name: str):
    t0 = time.time()
    try:
        yield
    finally:
        report.stages[name] = report.stages.get(name, 0.0) + time.time() - t0


def measure(codec: str, fn, data: bytes, device: str = "cuda") -> RunReport:
    """Run fn(data) once and report its sizes and host seconds. `device`
    names where fn runs; fn itself must finish its device work (a
    tpz_torch entry point returns bytes, so it has)."""
    r = RunReport(codec=codec, backend=str(device), bytes_in=len(data))
    t0 = time.time()
    out = fn(data)
    r.seconds = time.time() - t0
    r.bytes_out = len(out)
    return r


def scaling_efficiency(t1: float, tn: float, n: int) -> float:
    """T(1 host) / (N * T(N hosts))."""
    return t1 / (n * tn) if tn > 0 else 0.0
