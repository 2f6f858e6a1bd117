"""tpz_torch/utils/profiling.py: a trace of an annotated region on the
CPU is written as a chrome trace that names the region."""

import glob
import json
import os

import torch

from tpz_torch.utils import profiling


def test_trace_names_the_annotated_region(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, device="cpu"):
        with profiling.annotate("tpz_probe"):
            torch.arange(1024).cumsum(0)
    paths = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tpz_probe" for e in events)
