"""`correct` has teeth: a run on the CPU, past the look for a card, with
the plain reference standing in for the program, is correct; with each
fault planted under it, and with the control, it is not. The cells'
traffic is cut to test sizes (conftest.small_root)."""

import os
import subprocess
import sys
import time

import pytest

from benchmark import controls, harness, manifest

CELLS = ["gzip6.archive", "gzip6.read", "bzip2-9.read", "bzip2-9.archive"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_with(root, cell, make_entries, seed=4_000_000_001):
    bench = manifest.Bench(root)
    spec = bench.cell(cell)
    cfg = bench.config(spec["config"])
    entry = bench.traffic(spec["traffic"])["entry"]
    return harness.run(bench, cell, seed, 0.2, False,
                       t_start=time.perf_counter(), device="cpu",
                       entries=make_entries(cfg, entry))


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_in_the_programs_place_is_correct(small_root, cell):
    out = run_with(small_root, cell, controls.stand_in)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"] == {"wrong_objects": {"value": 0, "limit": 0}}
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1
    names = {m["name"] for m in manifest.Bench(small_root).end_to_end(cell)}
    assert set(out["metrics"]) == names


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_makes_the_run_incorrect(small_root, cell, fault):
    def broken(cfg, entry):
        call, hooked = controls.stand_in(cfg, entry)
        return controls.FAULTS[fault](call), hooked

    out = run_with(small_root, cell, broken)
    assert not out["correct"]
    assert out["checks"]["wrong_objects"]["value"] >= 1
    assert out["failed"] == out["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_incorrect_on_every_object(small_root, cell):
    out = run_with(small_root, cell, controls.control)
    assert not out["correct"]
    bench = manifest.Bench(small_root)
    per = bench.traffic(bench.cell(cell)["traffic"])["objects_per_request"]
    assert out["checks"]["wrong_objects"]["value"] == out["attempted"] * per


def test_a_stream_that_fails_the_reference_is_not_stored():
    """stored_pct reads only streams the reference restored."""
    rec = {"entry": "compress_many",
           "window": {"stored_bytes": 0, "stored_plain_bytes": 0}}
    bench = manifest.Bench(ROOT)
    assert bench.reader("stored_pct")(rec) is None


def test_run_without_the_program_or_a_card_prints_no_result(tmp_path):
    """Exits non-zero with nothing on stdout in a directory that holds
    only the manifest and the benchmark, and, where there is no card,
    in the repository too."""
    import torch

    from benchmark.conftest import copy_bench

    roots = [copy_bench(str(tmp_path))]
    if not torch.cuda.is_available():
        roots.append(ROOT)
    for root in roots:
        r = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
             "--seed", "4000000003", "--seconds", "1", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and r.stdout == ""
