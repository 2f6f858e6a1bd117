"""The harness on the card, at test sizes (conftest.small_root): the
program through every cell's traced run is correct and reports each
per-layer metric the cell lists; a fault planted under the program's own
entry makes the run incorrect; the stage split names the hooked entry's
stages. Each test skips where there is no card."""

import time

import pytest

from benchmark import controls, harness, manifest, stages

CELLS = ["gzip6.archive", "gzip6.read", "bzip2-9.read", "bzip2-9.archive"]
pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_and_every_metric_is_read(small_root, card,
                                                         cell):
    bench = manifest.Bench(small_root)
    for trace in (False, True):
        out = harness.run(bench, cell, 4_000_000_007, 0.5, trace,
                          t_start=time.perf_counter(), device=card)
        assert out["correct"], out["checks"]
        wanted = (bench.per_layer(cell) if trace else bench.end_to_end(cell))
        assert set(out["metrics"]) == {m["name"] for m in wanted}
        assert out["device"]["platform"] == "gpu"
        if trace:
            assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
            assert out["breakdown"]["device_ops"]


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_program_makes_the_run_incorrect(small_root, card,
                                                           cell, fault):
    bench = manifest.Bench(small_root)
    spec = bench.cell(cell)
    cfg = bench.config(spec["config"])
    entry = bench.traffic(spec["traffic"])["entry"]
    call, hooked = harness.program_entries(cfg, entry, card)
    out = harness.run(bench, cell, 4_000_000_009, 0.2, False,
                      t_start=time.perf_counter(), device=card,
                      entries=(controls.FAULTS[fault](call), hooked))
    assert not out["correct"]
    assert out["checks"]["wrong_objects"]["value"] >= 1


def test_stage_split_names_the_hooked_entrys_stages(small_root, card):
    bench = manifest.Bench(small_root)
    cell = harness.Cell(bench, "gzip6.archive", 4_000_000_011)
    _, hooked = harness.program_entries(cell.cfg, cell.entry, card)
    split, out = stages.stage_split(
        lambda hook: hooked(cell.batch(cell.rotation[0]), hook))
    assert {"words", "screen", "parse", "plan", "bitpack",
            "fetch"} <= set(split)
    assert all(ms >= 0 for ms in split.values()) and len(out) == 2
