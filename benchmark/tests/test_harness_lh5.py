"""The lh5 deployment: its configuration and cells hold to the contract,
run through the harness on the CPU with the plain reference standing in
for the program (correct) and with the control or a fault planted
(not correct), and the traced run's hooked entries give the api's
bytes. The cells' traffic is cut to test sizes (conftest.small_root)."""

import os
import time

import pytest

from benchmark import controls, harness, manifest
from benchmark.reference import lzhuf_ref

CELLS = ["lh5.archive", "lh5.read"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_with(root, cell, make_entries, seed=4_000_000_021):
    bench = manifest.Bench(root)
    spec = bench.cell(cell)
    cfg = bench.config(spec["config"])
    entry = bench.traffic(spec["traffic"])["entry"]
    return harness.run(bench, cell, seed, 0.2, False,
                       t_start=time.perf_counter(), device="cpu",
                       entries=make_entries(cfg, entry))


def test_the_configuration_and_its_cells_hold_to_the_contract():
    bench = manifest.Bench(ROOT)
    assert manifest.validate(bench) == []
    entry = next(c for c in bench.m["configs"] if c["name"] == "lh5")
    assert entry["reduced"] == [] and entry["source"].startswith("https://")
    cfg = bench.config("lh5")
    assert (cfg["format"], cfg["window_bytes"], cfg["reference"]) == (
        "lh5", lzhuf_ref.WINDOW, "lzhuf_ref")
    assert cfg["content"] == bench.config("gzip6")["content"]
    assert cfg["assumed"] == bench.config("gzip6")["assumed"]
    cells = {c["name"]: c for c in bench.m["workloads"]}
    assert (cells["lh5.archive"]["traffic"], cells["lh5.read"]["traffic"]) \
        == ("archive.2x16MiB", "read.4x4MiB")
    assert all(cells[c]["chips"] == 1 and cells[c]["config"] == "lh5"
               for c in CELLS)
    assert [m["name"] for m in bench.end_to_end("lh5.read")] == [
        "decode_MBps", "setup_s"]
    assert [m["name"] for m in bench.end_to_end("lh5.archive")] == [
        "encode_MBps", "stored_pct", "setup_s"]
    assert {m["name"] for m in bench.per_layer("lh5.read")} >= {
        "lzhuf.read_host_ms", "lzhuf.read_walk_ms",
        "lzhuf.read_host_declines", "kernels.decode_roofline"}
    assert {m["name"] for m in bench.per_layer("lh5.archive")} >= {
        "lzhuf.screen_parse_ms", "lzhuf.plan_ms", "lzhuf.pack_ms",
        "kernels.encode_roofline"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_in_the_programs_place_is_correct(small_root, cell):
    out = run_with(small_root, cell, controls.stand_in)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"] == {"wrong_objects": {"value": 0, "limit": 0}}
    names = {m["name"] for m in manifest.Bench(small_root).end_to_end(cell)}
    assert set(out["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_incorrect_on_every_object(small_root, cell):
    out = run_with(small_root, cell, controls.control)
    assert not out["correct"]
    bench = manifest.Bench(small_root)
    per = bench.traffic(bench.cell(cell)["traffic"])["objects_per_request"]
    assert out["checks"]["wrong_objects"]["value"] == out["attempted"] * per


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_makes_the_run_incorrect(small_root, cell, fault):
    def broken(cfg, entry):
        call, hooked = controls.stand_in(cfg, entry)
        return controls.FAULTS[fault](call), hooked

    out = run_with(small_root, cell, broken)
    assert not out["correct"]
    assert out["failed"] == out["attempted"]


def test_the_read_cells_streams_are_the_references(small_root):
    cell = harness.Cell(manifest.Bench(small_root), "lh5.read",
                        4_000_000_023)
    assert [lzhuf_ref.decode(s) for s in cell.inputs] == cell.objs


def test_the_hooked_entries_give_the_api_calls_bytes(small_root):
    """On the CPU, at a few KiB: the hooked encode's streams are the api
    encode's, byte for byte, and the hooked decode reads them; each hook
    sees its pipeline's stages."""
    import torch

    cfg = manifest.Bench(small_root).config("lh5")
    batch = [bytes(range(200)) * 9, b"lh5 object " * 300]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        api_enc, hooked_enc = harness.program_entries(cfg, "compress_many",
                                                      "cpu")
        seen = []
        streams = hooked_enc(batch, seen.append)
        assert streams == api_enc(batch)
        assert seen == ["blocks", "screen", "parse", "hist", "plan", "pack",
                        "fetch", "merge", "frame"]
        assert [lzhuf_ref.decode(s) for s in streams] == batch
        api_dec, hooked_dec = harness.program_entries(cfg, "decompress_many",
                                                      "cpu")
        seen = []
        assert hooked_dec(streams, seen.append) == batch == api_dec(streams)
        assert seen[:2] == ["index", "tables"] and "walk" in seen
    finally:
        torch.set_num_threads(n)


# Each lzhuf stage metric and the hooked stages it sums.
STAGE_METRICS = {
    "lzhuf.screen_parse_ms": ("compress_many", ["screen", "parse"]),
    "lzhuf.plan_ms": ("compress_many", ["hist", "plan"]),
    "lzhuf.pack_ms": ("compress_many", ["pack", "fetch", "merge", "frame"]),
    "lzhuf.read_host_ms": ("decompress_many", ["index", "tables", "layout"]),
    "lzhuf.read_walk_ms": ("decompress_many",
                           ["walk", "materialize", "resolve"]),
}


@pytest.mark.parametrize("metric", sorted(STAGE_METRICS))
def test_the_lzhuf_stage_metrics_read_the_hooked_stages(metric):
    """The median over the hooked requests of the named stages' summed
    CUDA-event times; None where no request passed one of them."""
    entry, names = STAGE_METRICS[metric]
    read = manifest.Bench(ROOT).reader(metric)
    others = {"blocks": 5.0, "h2d": 7.0}
    splits = [dict(others, **{n: float(r + k) for k, n in enumerate(names)})
              for r in (1, 10, 100)]
    rec = {"entry": entry, "stages": splits}
    assert read(rec) == sum(10.0 + k for k in range(len(names)))
    assert read({"entry": entry, "stages": [others]}) is None
    assert read({"entry": entry}) is None
