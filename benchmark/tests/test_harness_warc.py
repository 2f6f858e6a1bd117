"""The warc deployment and the bzip2-9.read-small cell: the configuration
and both cells hold to the contract and list the metrics they read; the
plain reference writes files stdlib gzip reads, cut by the schedule the
configuration states, and its reader is strict; run through the harness
on the CPU with the plain reference standing in for the program the
cells are correct, and with the control or a fault planted they are
not; the traced run's hooked entries read what the api reads and see
its stages; gzip.crc_ms reads its span. The cells' traffic is cut to
test sizes (conftest.small_root)."""

import gzip
import os
import time
import zlib

import pytest

from benchmark import controls, corpus, harness, manifest
from benchmark.reference import warc_ref

CELLS = ["warc.read", "bzip2-9.read-small"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WARC_METRICS = ["inflate.index_ms", "inflate.scan_ms", "inflate.walk_ms",
                "inflate.device_batches", "kernels.decode_roofline",
                "device.idle_pct.decode", "host.unspanned_ms.decode",
                "gzip.crc_ms"]
BZIP2_METRICS = ["bzip2.read_host_ms", "bzip2.read_index_ms",
                 "bzip2.rle1_inverse_ms", "bzip2.read_walk_ms",
                 "kernels.decode_roofline", "device.idle_pct.decode",
                 "host.unspanned_ms.decode"]


def run_with(root, cell, make_entries, seed=4_000_000_041):
    bench = manifest.Bench(root)
    spec = bench.cell(cell)
    cfg = bench.config(spec["config"])
    entry = bench.traffic(spec["traffic"])["entry"]
    return harness.run(bench, cell, seed, 0.2, False,
                       t_start=time.perf_counter(), device="cpu",
                       entries=make_entries(cfg, entry))


def members(stream: bytes) -> list[bytes]:
    """Each member's plaintext, read by libz member after member."""
    out = []
    while stream:
        d = zlib.decompressobj(31)
        out.append(d.decompress(stream))
        assert d.eof
        stream = d.unused_data
    return out


def test_the_configuration_and_its_cells_hold_to_the_contract():
    bench = manifest.Bench(ROOT)
    assert manifest.validate(bench) == []
    entry = next(c for c in bench.m["configs"] if c["name"] == "warc")
    assert entry["reduced"] == ["file_bytes"]
    assert entry["source"].startswith("https://iipc.github.io/")
    cfg = bench.config("warc")
    assert (cfg["format"], cfg["level"], cfg["reference"]) == (
        "gzip", 6, "warc_ref")
    assert cfg["content"] == bench.config("gzip6")["content"]
    assert cfg["hooked"] == bench.config("gzip6")["hooked"]
    assert cfg["reduced"] == ["file_bytes"]
    cells = {c["name"]: c for c in bench.m["workloads"]}
    assert (cells["warc.read"]["config"], cells["warc.read"]["traffic"]) \
        == ("warc", "read.2x16MiB")
    assert (cells["bzip2-9.read-small"]["config"],
            cells["bzip2-9.read-small"]["traffic"]) == (
        "bzip2-9", "read.4x4MiB")
    assert all(cells[c]["chips"] == 1 for c in CELLS)
    assert cfg["file_bytes"] == bench.traffic("read.2x16MiB")["object_bytes"]
    assert [m["name"] for m in bench.end_to_end("warc.read")] == [
        "decode_MBps", "setup_s"]
    assert [m["name"] for m in bench.end_to_end("bzip2-9.read-small")] == [
        "decode_MBps", "read_p95_ms", "setup_s"]
    assert sorted(m["name"] for m in bench.per_layer("warc.read")) == \
        sorted(WARC_METRICS)
    assert sorted(m["name"] for m in bench.per_layer(
        "bzip2-9.read-small")) == sorted(BZIP2_METRICS)
    crc = next(m for m in bench.m["per_layer"] if m["name"] == "gzip.crc_ms")
    assert crc["workloads"] == ["warc.read", "gzip6.read"]
    assert (crc["moves"], crc["unit"], crc["layer"]) == (
        "decode_MBps", "ms", "codecs.gzip_codec trailer checks")


def test_the_references_schedule_is_the_configurations():
    s = manifest.Bench(ROOT).config("warc")["record_schedule"]
    assert s["order"] == ["request", "response", "metadata"]
    assert (s["request_bytes"], tuple(s["response_bytes"]),
            s["metadata_bytes"]) == (warc_ref.REQUEST, warc_ref.RESPONSES,
                                     warc_ref.METADATA)
    sizes = warc_ref.record_sizes(10 ** 6)
    assert sizes[:7] == [768, 8192, 512, 768, 32768, 512, 768]
    assert sizes[7:12:3] == [98304, 262144]
    assert sum(sizes) == 10 ** 6 and 0 < sizes[-1]


@pytest.mark.parametrize("n", [0, 1, 767, 768, 9472, 9473, 200_000])
def test_the_references_files_are_one_member_a_record(n):
    obj = corpus.pool(4_000_000_043 + n, 1, n,
                      manifest.Bench(ROOT).config("warc")["content"])[0]
    f = warc_ref.encode(obj, 6)
    assert gzip.decompress(f) == obj == warc_ref.decode(f)
    parts = members(f)
    assert [len(p) for p in parts] == (warc_ref.record_sizes(n) or [0])
    assert b"".join(parts) == obj
    # A plain header on every member: no FEXTRA, FNAME or FCOMMENT.
    off = 0
    for p in parts:
        assert f[off:off + 4] == b"\x1f\x8b\x08\x00"
        c = zlib.compressobj(6, zlib.DEFLATED, 31)
        off += len(c.compress(p) + c.flush())
    assert off == len(f)


def test_a_16_MiB_object_is_500_members_two_thirds_under_1_KiB():
    n = manifest.Bench(ROOT).config("warc")["file_bytes"]
    sizes = warc_ref.record_sizes(n)
    assert len(sizes) == 500
    assert sum(s < 1024 for s in sizes) == 333
    obj = corpus.pool(4_000_000_045, 1, n,
                      manifest.Bench(ROOT).config("warc")["content"])[0]
    assert len(members(warc_ref.encode(obj, 6))) == 500


BREACHES = {
    "a-member-cut": lambda f: f[:len(f) - 3],
    "cut-inside-the-second-member": lambda f: f[:len(members(f)[0]) // 4
                                               + 40],
    "bytes-after-the-last-member": lambda f: f + b"\0",
    "garbage-after-the-last-member": lambda f: f + b"not a member at all",
    "zeroed-crc": warc_ref.break_integrity,
    "no-member": lambda f: b"",
}


@pytest.mark.parametrize("breach", sorted(BREACHES))
def test_the_references_reader_is_strict(breach):
    obj = b"WARC/1.1\r\nWARC-Type: response\r\n\r\n" * 400
    f = warc_ref.encode(obj, 6)
    assert warc_ref.decode(f) == obj
    with pytest.raises(ValueError):
        warc_ref.decode(BREACHES[breach](f))


def test_break_integrity_zeroes_the_first_members_crc_alone():
    f = warc_ref.encode(bytes(range(256)) * 40, 6)
    d = zlib.decompressobj(31)
    d.decompress(f)
    end = len(f) - len(d.unused_data)
    assert warc_ref.break_integrity(f) == (f[:end - 8] + b"\0" * 4
                                           + f[end - 4:])
    assert f[end - 8:end - 4] != b"\0" * 4


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


def test_files_with_a_broken_crc_read_wrong_everywhere(small_root):
    """break_integrity on every file of the warc.read pool: the strict
    reader refuses each, so a stand-in that read through it would get
    every object wrong."""
    cell = harness.Cell(manifest.Bench(small_root), "warc.read",
                        4_000_000_047)
    for s in cell.inputs:
        with pytest.raises(ValueError):
            warc_ref.decode(warc_ref.break_integrity(s))
        with pytest.raises(Exception):
            gzip.decompress(warc_ref.break_integrity(s))


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
    cell = harness.Cell(manifest.Bench(small_root), "warc.read",
                        4_000_000_049)
    assert [warc_ref.decode(s) for s in cell.inputs] == cell.objs
    for s, obj in zip(cell.inputs, cell.objs):
        assert [len(p) for p in members(s)] == warc_ref.record_sizes(
            len(obj))


def test_the_hooked_entry_reads_what_the_api_reads(small_root):
    """On the CPU, at a few KiB: the hooked decode and the api decode
    read the reference's files to their objects, every member in one
    batch, and the hook sees the decode's stages, then the checks."""
    import torch
    from tpz_torch.codecs import gzip_codec

    cfg = manifest.Bench(small_root).config("warc")
    batch = [bytes(range(200)) * 9, b"warc record " * 300]
    files = [warc_ref.encode(d, 6) for d in batch]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        api_dec, hooked_dec = harness.program_entries(cfg, "decompress_many",
                                                      "cpu")
        before = gzip_codec.members
        seen = []
        assert hooked_dec(files, seen.append) == batch
        assert gzip_codec.members - before == sum(
            len(warc_ref.record_sizes(len(d))) for d in batch)
        assert seen == ["scan", "h2d", "walk", "materialize", "resolve",
                        "fetch", "crc"]
        assert api_dec(files) == batch
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


def test_gzip_crc_ms_reads_its_span():
    """A request's time in gzip.crc, ms (two spans of a request summed);
    None without one, and None on an encode."""
    read = manifest.Bench(ROOT).reader("gzip.crc_ms")
    rec = _profile(("inflate.batch", 20.0, 100.0), ("gzip.crc", 200.0, 250.0),
                   ("gzip.crc", 600.0, 50.0))
    assert read(rec) == 0.3
    assert read(_profile(("inflate.batch", 20.0, 100.0))) is None
    assert read(dict(rec, entry="compress_many")) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_program_is_correct_and_reads_every_metric(
        small_root, card, cell):
    bench = manifest.Bench(small_root)
    for trace in (False, True):
        out = harness.run(bench, cell, 4_000_000_051, 0.5, trace,
                          t_start=time.perf_counter(), device=card)
        assert out["correct"], out["checks"]
        wanted = (bench.per_layer(cell) if trace else bench.end_to_end(cell))
        assert set(out["metrics"]) == {m["name"] for m in wanted}
    if cell == "warc.read":
        assert out["metrics"]["inflate.device_batches"]["value"] == 1
