"""A deployment, a traffic mix and a per-layer metric are added by new
files and new BENCHMARK.json entries alone: in a copy of the benchmark,
the harness finds them by name, the manifest still holds to the
contract, the new cell's inputs are made (and a new read traffic is run
through on the CPU), and the new reader reads a hand-made event list.
Nothing is measured: no card is used."""

import json
import os
import shutil
import time

import pytest

from benchmark import corpus, harness, manifest, traceops
from benchmark.conftest import copy_bench

READER = '''"""Device time of the profiled requests' memory copies, ms."""

from benchmark import traceops


def read(rec):
    p = rec.get("profile")
    if not p:
        return None
    return sum(e.dur for e in p["device"] if e.cat == "gpu_memcpy") / 1e3
'''


@pytest.fixture
def grown(tmp_path):
    """The benchmark's copy plus a gzip -1 deployment, a traffic mix of
    64 KiB objects and a metric of memcpy time, each in a file of its
    own, and their entries in BENCHMARK.json."""
    root = copy_bench(str(tmp_path))
    home = os.path.join(root, "benchmark")
    with open(os.path.join(home, "configs", "gzip6.json")) as f:
        cfg = json.load(f)
    cfg.update(name="gzip1", level=1)
    with open(os.path.join(home, "configs", "gzip1.json"), "w") as f:
        json.dump(cfg, f)
    traffic = os.path.join(home, "traffic", "archive.4x64KiB.json")
    with open(traffic, "w") as f:
        json.dump({"entry": "compress_many", "objects_per_request": 4,
                   "object_bytes": 65536, "pool_objects": 8}, f)
    with open(os.path.join(home, "metrics", "memcpy_ms.py"), "w") as f:
        f.write(READER)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        m = json.load(f)
    m["configs"].append({"name": "gzip1", "source": "https://www.gnu.org/"
                         "software/gzip/manual/gzip.html",
                         "file": "benchmark/configs/gzip1.json",
                         "reduced": [], "why": "gzip -1, the fastest level"})
    m["workloads"].append({"name": "gzip1.small", "config": "gzip1",
                           "traffic": "archive.4x64KiB", "chips": 1,
                           "why": "4 x 64 KiB objects a request"})
    for x in m["end_to_end"]:
        if x["name"] in ("encode_MBps", "stored_pct"):
            x["workloads"].append("gzip1.small")
    m["per_layer"].append({"name": "memcpy_ms", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "encode_MBps",
                           "workloads": ["gzip1.small"]})
    with open(path, "w") as f:
        json.dump(m, f)
    return root


def test_the_repositorys_manifest_holds_to_the_contract():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    assert manifest.validate(manifest.Bench(root)) == []


def test_new_files_and_entries_are_found_by_name(grown):
    bench = manifest.Bench(grown)
    assert manifest.validate(bench) == []
    assert bench.config("gzip1")["level"] == 1
    assert bench.traffic("archive.4x64KiB")["object_bytes"] == 65536
    assert [m["name"] for m in bench.end_to_end("gzip1.small")] == [
        "encode_MBps", "stored_pct", "setup_s"]
    assert [m["name"] for m in bench.per_layer("gzip1.small")] == [
        "memcpy_ms"]
    cell = harness.Cell(bench, "gzip1.small", 4_000_000_005)
    assert cell.rotation == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert cell.objs == corpus.pool(4_000_000_005, 8, 65536,
                                    bench.config("gzip1")["content"])
    api_call, hooked = harness.program_entries(cell.cfg, cell.entry, "cpu")
    assert callable(api_call) and callable(hooked)


def test_a_read_cell_of_new_traffic_runs_through(grown):
    """A traffic file alone adds a read of stock bzip2 streams of another
    size; run here on the CPU through the program, past the look for a
    card, it is correct."""
    path = os.path.join(grown, "benchmark", "traffic", "read.3x6KiB.json")
    with open(path, "w") as f:
        json.dump({"entry": "decompress_many", "objects_per_request": 3, "object_bytes": 6144,
                   "pool_objects": 6}, f)
    mpath = os.path.join(grown, "BENCHMARK.json")
    with open(mpath) as f:
        m = json.load(f)
    m["workloads"].append({"name": "bzip2-9.read-tiny", "config": "bzip2-9",
                           "traffic": "read.3x6KiB", "chips": 1,
                           "why": "3 x 6 KiB stock .bz2 a request"})
    for x in m["end_to_end"] + m["per_layer"]:
        if "decode_MBps" in (x["name"], x.get("moves")) and "workloads" in x:
            x["workloads"].append("bzip2-9.read-tiny")
    with open(mpath, "w") as f:
        json.dump(m, f)
    bench = manifest.Bench(grown)
    assert manifest.validate(bench) == []
    cell = harness.Cell(bench, "bzip2-9.read-tiny", 4_000_000_013)
    assert [len(o) for o in cell.objs] == [6144] * 6
    assert all(s[:4] == b"BZh9" for s in cell.inputs)
    out = harness.run(bench, "bzip2-9.read-tiny", 4_000_000_013, 0.1,
                      False, t_start=time.perf_counter(), device="cpu")
    assert out["correct"] and out["checks"]["wrong_objects"]["value"] == 0
    assert set(out["metrics"]) == {"decode_MBps", "setup_s"}


def test_the_new_reader_reads_a_hand_made_event_list(grown):
    E = traceops.Event
    events = [E("benchmark.profiled", "user_annotation", 0.0, 100.0, 0),
              E("cudaMemcpyAsync", "cuda_runtime", 10.0, 1.0, 1),
              E("cudaLaunchKernel", "cuda_runtime", 20.0, 1.0, 2),
              E("Memcpy HtoD", "gpu_memcpy", 12.0, 250.0, 1),
              E("k", "kernel", 30.0, 5.0, 2)]
    dev = traceops.launched(events, 0.0, 100.0)
    rec = {"entry": "compress_many",
           "profile": {"events": events, "t0": 0.0, "t1": 100.0,
                       "device": dev}}
    read = manifest.Bench(grown).reader("memcpy_ms")
    assert read(rec) == 0.25
    assert read({"entry": "compress_many"}) is None


def test_a_metric_without_its_reader_breaks_the_manifest(grown):
    os.remove(os.path.join(grown, "benchmark", "metrics", "memcpy_ms.py"))
    assert manifest.validate(manifest.Bench(grown)) == [
        "metric memcpy_ms has no reader"]
    shutil.rmtree(os.path.join(grown, "benchmark", "traffic"))
    assert any("traffic" in b
               for b in manifest.validate(manifest.Bench(grown)))
