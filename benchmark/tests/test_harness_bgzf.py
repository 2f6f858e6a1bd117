"""The bgzf deployment and the gzip6.small-objects cell: the configuration
and both cells hold to the contract and list the metrics they read; run
through the harness on the CPU with the plain reference standing in for
the program they are correct, and with the control or a fault planted
they are not; the read cell's streams are the reference writer's; the
traced run's hooked entries give the api's bytes and see their stages.
The cells' traffic is cut to test sizes (conftest.small_root, and
archive.64x64KiB here)."""

import json
import os
import struct
import time

import pytest

from benchmark import controls, corpus, harness, manifest
from benchmark.reference import bgzf_ref

CELLS = ["bgzf.read", "gzip6.small-objects"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
READ_METRICS = ["inflate.index_ms", "inflate.scan_ms", "inflate.walk_ms",
                "inflate.device_batches", "kernels.decode_roofline",
                "device.idle_pct.decode", "host.unspanned_ms.decode",
                "bgzf.split_ms", "bgzf.read_declines"]
ENCODE_METRICS = ["kernels.encode_roofline", "device.idle_pct.encode",
                  "host.unspanned_ms.encode", "deflate.layout_ms",
                  "deflate.screen_ms", "deflate.screen_kernel_ms",
                  "deflate.parse_plan_ms", "deflate.bitpack_ms",
                  "codecs.frame_ms.encode"]


@pytest.fixture
def root(small_root):
    """small_root with the 64-object traffic cut to 4 KiB objects and a
    pool of two requests."""
    path = os.path.join(small_root, "benchmark", "traffic",
                        "archive.64x64KiB.json")
    with open(path) as f:
        t = json.load(f)
    t.update(object_bytes=4096, pool_objects=2 * t["objects_per_request"])
    with open(path, "w") as f:
        json.dump(t, f)
    return small_root


def run_with(root, cell, make_entries, seed=4_000_000_031):
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
    entry = next(c for c in bench.m["configs"] if c["name"] == "bgzf")
    assert entry["reduced"] == [] and entry["source"].startswith("https://")
    cfg = bench.config("bgzf")
    assert (cfg["format"], cfg["level"], cfg["reference"]) == (
        "bgzf", 6, "bgzf_ref")
    assert (cfg["block_input_bytes"], cfg["max_member_bytes"]) == (
        bgzf_ref.BLOCK, bgzf_ref.MAX_BLOCK)
    assert cfg["content"] == bench.config("gzip6")["content"]
    cells = {c["name"]: c for c in bench.m["workloads"]}
    assert (cells["bgzf.read"]["config"], cells["bgzf.read"]["traffic"]) \
        == ("bgzf", "read.2x16MiB")
    assert (cells["gzip6.small-objects"]["config"],
            cells["gzip6.small-objects"]["traffic"]) == (
        "gzip6", "archive.64x64KiB")
    assert all(cells[c]["chips"] == 1 for c in CELLS)
    t = bench.traffic("archive.64x64KiB")
    assert (t["entry"], t["objects_per_request"], t["object_bytes"],
            t["pool_objects"]) == ("compress_many", 64, 65536, 256)
    assert [m["name"] for m in bench.end_to_end("bgzf.read")] == [
        "decode_MBps", "setup_s"]
    assert [m["name"] for m in bench.end_to_end("gzip6.small-objects")] == [
        "encode_MBps", "stored_pct", "setup_s"]
    assert sorted(m["name"] for m in bench.per_layer("bgzf.read")) == \
        sorted(READ_METRICS)
    assert sorted(m["name"] for m in bench.per_layer(
        "gzip6.small-objects")) == sorted(ENCODE_METRICS)
    new = {m["name"]: m for m in bench.m["per_layer"]
           if m["name"].startswith("bgzf.")}
    assert sorted(new) == ["bgzf.read_declines", "bgzf.split_ms"]
    assert all(m["workloads"] == ["bgzf.read"]
               and m["moves"] == "decode_MBps" for m in new.values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_in_the_programs_place_is_correct(root, cell):
    out = run_with(root, cell, controls.stand_in)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"] == {"wrong_objects": {"value": 0, "limit": 0}}
    names = {m["name"] for m in manifest.Bench(root).end_to_end(cell)}
    assert set(out["metrics"]) == names


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_incorrect_on_every_object(root, cell):
    out = run_with(root, cell, controls.control)
    assert not out["correct"]
    bench = manifest.Bench(root)
    per = bench.traffic(bench.cell(cell)["traffic"])["objects_per_request"]
    assert out["checks"]["wrong_objects"]["value"] == out["attempted"] * per


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_makes_the_run_incorrect(root, cell, fault):
    def broken(cfg, entry):
        call, hooked = controls.stand_in(cfg, entry)
        return controls.FAULTS[fault](call), hooked

    out = run_with(root, cell, broken)
    assert not out["correct"]
    assert out["failed"] == out["attempted"]


def members(stream: bytes) -> list[int]:
    """Each member's size, from its BSIZE."""
    sizes, off = [], 0
    while off < len(stream):
        (bsize,) = struct.unpack_from("<H", stream, off + 16)
        sizes.append(bsize + 1)
        off += bsize + 1
    return sizes


def test_the_read_cells_streams_are_the_references(root):
    cell = harness.Cell(manifest.Bench(root), "bgzf.read", 4_000_000_033)
    assert [bgzf_ref.decode(s) for s in cell.inputs] == cell.objs
    for s, obj in zip(cell.inputs, cell.objs):
        sizes = members(s)
        assert len(sizes) == -(-len(obj) // bgzf_ref.BLOCK) + 1
        assert max(sizes) <= bgzf_ref.MAX_BLOCK
        assert s.endswith(bgzf_ref.EOF)


def test_the_hooked_entries_give_the_api_calls_bytes(root):
    """On the CPU, at a few KiB: the hooked encode's files are the api
    encode's, byte for byte, and the reference reads them; the hooked
    decode reads them; each hook sees its pipeline's stages."""
    import torch

    cfg = manifest.Bench(root).config("bgzf")
    batch = [bytes(range(200)) * 9, b"bgzf object " * 300]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        api_enc, hooked_enc = harness.program_entries(cfg, "compress_many",
                                                      "cpu")
        seen = []
        files = hooked_enc(batch, seen.append)
        assert files == api_enc(batch)
        assert seen == ["words", "screen", "parse", "plan", "bitpack",
                        "fetch", "frame"]
        assert [bgzf_ref.decode(s) for s in files] == batch
        api_dec, hooked_dec = harness.program_entries(cfg, "decompress_many",
                                                      "cpu")
        seen = []
        assert hooked_dec(files, seen.append) == batch == api_dec(files)
        assert seen == ["split", "scan", "h2d", "walk", "materialize",
                        "resolve", "fetch", "crc"]
    finally:
        torch.set_num_threads(n)


def _profile(*spans):
    """A hand-made profile of one decode request holding `spans`, each
    (name less tpz_torch., start us, duration us)."""
    from benchmark import traceops

    E = traceops.Event
    events = [E("benchmark.profiled", "user_annotation", 0.0, 1000.0, 0),
              E("tpz_torch.api.decompress_many", "user_annotation", 10.0,
                900.0, 1)]
    events += [E("tpz_torch." + n, "user_annotation", ts, dur, 2 + k)
               for k, (n, ts, dur) in enumerate(spans)]
    return {"entry": "decompress_many",
            "profile": {"events": events, "t0": 0.0, "t1": 1000.0,
                        "device": [], "complete": True}}


def test_the_bgzf_metrics_read_their_spans():
    """bgzf.split_ms: a request's time in bgzf.split, ms; None without
    one. bgzf.read_declines: its bgzf.decline spans, 0 without one.
    Neither reads an encode."""
    bench = manifest.Bench(ROOT)
    split = bench.reader("bgzf.split_ms")
    declines = bench.reader("bgzf.read_declines")
    rec = _profile(("bgzf.split", 20.0, 250.0),
                   ("bgzf.decline", 300.0, 50.0),
                   ("bgzf.decline", 400.0, 50.0))
    assert split(rec) == 0.25 and declines(rec) == 2
    bare = _profile(("inflate.batch", 20.0, 100.0))
    assert split(bare) is None and declines(bare) == 0
    enc = dict(rec, entry="compress_many")
    assert split(enc) is None and declines(enc) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_program_is_correct_and_reads_every_metric(root,
                                                                   card,
                                                                   cell):
    bench = manifest.Bench(root)
    for trace in (False, True):
        out = harness.run(bench, cell, 4_000_000_037, 0.5, trace,
                          t_start=time.perf_counter(), device=card)
        assert out["correct"], out["checks"]
        wanted = (bench.per_layer(cell) if trace else bench.end_to_end(cell))
        assert set(out["metrics"]) == {m["name"] for m in wanted}
    if cell == "bgzf.read":
        assert out["metrics"]["bgzf.read_declines"]["value"] == 0
        assert out["metrics"]["inflate.device_batches"]["value"] == 1


@pytest.mark.card
def test_on_the_card_the_ports_files_of_the_read_pool_are_bgzf(card):
    """The bgzf.read pool (8 x 16 MiB) through the api's encode on the
    card: the reference reads every file back, and every member is at
    most 65,536 bytes."""
    from tpz_torch import api

    bench = manifest.Bench(ROOT)
    cfg = bench.config("bgzf")
    t = bench.traffic(bench.cell("bgzf.read")["traffic"])
    objs = corpus.pool(4_000_000_039, t["pool_objects"], t["object_bytes"],
                       cfg["content"])
    files = api.compress_many(objs, "bgzf", cfg["level"], device=card)
    for f, obj in zip(files, objs):
        assert bgzf_ref.decode(f) == obj
        assert max(members(f)) <= bgzf_ref.MAX_BLOCK
