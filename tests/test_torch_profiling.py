"""tpz_torch/utils/profiling.py: with no profiler running a span enters
no profiler range and a stage only calls its hook; under the profiler
they are ranges named tpz_torch.<name>; a trace of a spanned region on
the CPU is written as a chrome trace that names the region."""

import glob
import gzip
import json
import os
import timeit

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpz_torch.codecs import gzip_codec
from tpz_torch.utils import profiling


def _no_range(name):
    raise AssertionError(f"record_function({name!r}) entered")


def _names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith("tpz_torch.")]


def test_trace_names_the_annotated_region(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, device="cpu"):
        with profiling.span("tpz_probe"):
            torch.arange(1024).cumsum(0)
    paths = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "tpz_torch.tpz_probe" for e in events)


def test_span_off_enters_no_profiler_range(monkeypatch):
    """With no profiler running, neither a span nor a stage enters
    record_function, down a whole decode; the stage still calls its
    hook, after its block."""
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    seen = []
    with profiling.span("probe"):
        seen.append("body")
    with profiling.stage("layer", "probe", seen.append):
        seen.append("stage body")
    with profiling.stage("layer", "quiet"):
        seen.append("no hook")
    assert seen == ["body", "stage body", "probe", "no hook"]
    blob = gzip.compress(b"spans" * 100)
    assert gzip_codec.decompress_many([blob], device="cpu",
                                      stage_hook=seen.append) == [
        b"spans" * 100]
    assert profiling.span("a") is profiling.span("b")


def test_span_off_costs_a_fraction_of_a_profiler_range():
    """One enabled-check and a shared null context, against entering and
    leaving record_function with no profiler running (about 0.2 us
    against 13 us with torch 2.13 on an x86 CPU), each the best of five
    runs."""
    def spanned():
        with profiling.span("probe"):
            pass

    def ranged():
        with torch.profiler.record_function("tpz_torch.probe"):
            pass

    def best(fn, n):
        return min(timeit.repeat(fn, number=n, repeat=5)) / n

    assert best(spanned, 20_000) < best(ranged, 2_000) / 5


def test_span_and_stage_on_are_named_ranges():
    seen = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("api.probe"):
            with profiling.stage("layer", "first", seen.append):
                torch.ones(8).sum()
            with profiling.stage("layer", "second"):
                pass
    assert seen == ["first"]
    assert sorted(_names(prof)) == ["tpz_torch.api.probe",
                                    "tpz_torch.layer.first",
                                    "tpz_torch.layer.second"]


@pytest.mark.parametrize("profiled", [False, True])
def test_a_stage_that_raises_calls_no_hook(profiled):
    seen = []
    with profile(activities=[ProfilerActivity.CPU], record_shapes=False) \
            if profiled else profiling._OFF:
        with pytest.raises(ValueError):
            with profiling.stage("layer", "bad", seen.append):
                raise ValueError("stage failed")
    assert seen == []
