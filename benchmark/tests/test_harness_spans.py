"""The span readers' arithmetic (`spans.py` and each reader of the
program's spans) on hand-made event lists: the split into requests along
the api spans of the profiled range, the session's clock shift, the
idle time by innermost span and the unspanned rest, None where the
profile is incomplete or the program emitted no spans; and, on the card,
a short traced run of each cell that reports every metric listed for it
(skipped without a card)."""

import os
import time

import pytest

from benchmark import harness, manifest, readers, spans
from benchmark.traceops import Event

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPAN_METRICS = {
    "gzip6.archive": ["deflate.layout_ms", "deflate.parse_plan_ms",
                      "deflate.screen_kernel_ms", "codecs.frame_ms.encode",
                      "host.unspanned_ms.encode"],
    "gzip6.read": ["inflate.index_ms", "inflate.device_batches",
                   "host.unspanned_ms.decode"],
    "bzip2-9.read": ["bzip2.read_index_ms", "bzip2.rle1_inverse_ms",
                     "host.unspanned_ms.decode"],
    "bzip2-9.archive": ["codecs.frame_ms.encode", "bzip2.mtf_plan_ms",
                        "host.unspanned_ms.encode"],
}


def span(name, t0, t1, cat="user_annotation"):
    return Event("tpz_torch." + name, cat, t0, t1 - t0, 0)


def launch(corr, ts, dev_ts, dur, kind="kernel"):
    """A launch call at ts and its device event, placed by the profiler
    at dev_ts."""
    call = "cudaLaunchKernel" if kind == "kernel" else "cudaMemcpyAsync"
    return [Event(call, "cuda_runtime", ts, 1.0, corr),
            Event(f"{kind} {corr}", kind, dev_ts, dur, corr)]


def encode_events(cat="user_annotation"):
    """Two profiled requests and a warm-up one before the profiled range.
    Device events sit 4 us early (the shift): the memcpy runs [51, 56],
    the screen's kernels [70, 170] and [530, 570] on the host clock."""
    s = lambda *a: span(*a, cat=cat)  # noqa: E731
    return ([Event("benchmark.profiled", "user_annotation", 0.0, 1000.0,
                   0),
             s("api.compress_many", -300, -100), s("deflate.layout", -290,
                                                   -200),
             s("api.compress_many", 10, 410), s("deflate.words", 10, 60),
             s("deflate.layout", 12, 40), s("deflate.h2d", 40, 58),
             s("deflate.words", 58, 60), s("deflate.screen", 60, 200),
             s("deflate.parse", 200, 250), s("deflate.plan", 250, 300),
             s("deflate.bitpack", 300, 350), s("deflate.fetch", 350, 380),
             s("gzip.frame", 385, 405),
             s("api.compress_many", 500, 700), s("deflate.words", 500, 520),
             s("api.compress", 505, 515), s("deflate.screen", 520, 600),
             s("gzip.frame", 600, 690)]
            + launch(1, 45.0, 47.0, 5.0, "gpu_memcpy")
            + launch(2, 70.0, 66.0, 100.0) + launch(3, 530.0, 526.0, 40.0))


def decode_events():
    """One profiled request of two streams, each its own batch."""
    return [Event("benchmark.profiled", "user_annotation", 0.0, 1000.0, 0),
            span("api.decompress_many", 0, 200),
            span("inflate.index", 5, 25), span("inflate.batch", 30, 80),
            span("inflate.scan", 30, 40), span("gzip.crc", 80, 90),
            span("inflate.index", 95, 110), span("inflate.batch", 115, 185),
            span("bzip2.scan", 0, 30), span("bzip2.slices", 30, 50),
            span("bzip2.eos", 150, 151), span("bzip2.rle1-inverse", 151, 190),
            span("bzip2.eos", 190, 191)] + launch(7, 40.0, 41.0, 30.0)


def record(events, entry, complete=True):
    return {"entry": entry,
            "profile": {"events": events, "t0": 0.0, "t1": 1000.0,
                        "complete": complete}}


def test_requests_split_along_the_api_spans_of_the_profiled_range():
    reqs = spans.requests(record(encode_events(), readers.ENCODE)["profile"])
    assert [(r.api.ts, r.api.end) for r in reqs] == [(10, 410), (500, 700)]
    assert [s.name for s in reqs[1].spans] == [
        "tpz_torch.deflate.words", "tpz_torch.api.compress",
        "tpz_torch.deflate.screen", "tpz_torch.gzip.frame"]
    assert [e.corr for e in reqs[0].device] == [1, 2]
    assert [e.corr for e in reqs[1].device] == [3]


def test_the_shift_puts_no_device_event_before_its_launch():
    events = encode_events()
    assert spans.shift_us(events) == 4.0
    reqs = spans.requests(record(events, readers.ENCODE)["profile"])
    assert [(e.ts, e.end) for e in reqs[0].device] == [(51.0, 56.0),
                                                       (70.0, 170.0)]
    late = [e for e in events if e.corr not in (2, 3)]
    assert spans.shift_us(late) == 0.0


def test_the_device_side_of_a_span_is_no_device_work():
    """On a torch without activity types the device side of a program
    span reads as a kernel; it is neither launched work nor shifted."""
    events = encode_events() + [
        Event("tpz_torch.deflate.screen", "kernel", 60.0, 200.0, 2)]
    assert spans.shift_us(events) == 4.0
    assert [e.corr for e in spans.launched(events, 60.0, 200.0)] == [2]
    read = manifest.Bench(ROOT).reader("deflate.screen_kernel_ms")
    assert read(record(events, readers.ENCODE)) == pytest.approx(0.07)


def test_idle_time_goes_to_the_innermost_span_and_the_rest_is_unspanned():
    r = spans.requests(record(encode_events(), readers.ENCODE)["profile"])[0]
    assert r.idle == [(10, 51.0), (56.0, 70.0), (170.0, 410)]
    assert spans.idle_by_span(r) == {
        "deflate.words": 4.0, "deflate.layout": 28.0, "deflate.h2d": 13.0,
        "deflate.screen": 40.0, "deflate.parse": 50.0, "deflate.plan": 50.0,
        "deflate.bitpack": 50.0, "deflate.fetch": 30.0, "gzip.frame": 20.0,
        spans.UNSPANNED: 10.0}


@pytest.mark.parametrize("cat", ["user_annotation", "cpu_op"])
@pytest.mark.parametrize("metric, want", [
    ("deflate.layout_ms", 0.046),
    ("deflate.parse_plan_ms", 0.1),
    ("deflate.screen_kernel_ms", 0.07),
    ("codecs.frame_ms.encode", 0.055),
    ("host.unspanned_ms.encode", 0.01),
])
def test_each_encode_reader_on_a_hand_made_list(metric, want, cat):
    read = manifest.Bench(ROOT).reader(metric)
    assert read(record(encode_events(cat), readers.ENCODE)) == \
        pytest.approx(want)
    assert read(record(encode_events(cat), readers.DECODE)) is None


@pytest.mark.parametrize("metric, want", [
    ("inflate.index_ms", 0.035),
    ("inflate.device_batches", 2),
    ("bzip2.read_index_ms", 0.05),
    ("bzip2.rle1_inverse_ms", 0.041),
    ("host.unspanned_ms.decode", 0.019),
])
def test_each_decode_reader_on_a_hand_made_list(metric, want):
    read = manifest.Bench(ROOT).reader(metric)
    assert read(record(decode_events(), readers.DECODE)) == \
        pytest.approx(want)
    assert read(record(decode_events(), readers.ENCODE)) is None


def test_unspanned_counts_only_idle_time():
    """A stretch no span covers reads as unspanned only while the device
    is idle in it."""
    events = [Event("benchmark.profiled", "user_annotation", 0.0, 100.0, 0),
              span("api.decompress_many", 0, 100),
              span("inflate.index", 0, 20)] + launch(1, 10.0, 30.0, 50.0)
    read = manifest.Bench(ROOT).reader("host.unspanned_ms.decode")
    assert read(record(events, readers.DECODE)) == pytest.approx(0.03)


@pytest.mark.parametrize("metric", sorted(
    {m for ms in SPAN_METRICS.values() for m in ms}))
def test_nothing_to_read_is_none(metric):
    """An incomplete profile, a program without spans, a record without
    a profile: the metric is left out of the line."""
    read = manifest.Bench(ROOT).reader(metric)
    for entry, events in ((readers.ENCODE, encode_events()),
                          (readers.DECODE, decode_events())):
        assert read(record(events, entry, complete=False)) is None
        bare = [e for e in events if not e.name.startswith("tpz_torch.")]
        assert read(record(bare, entry)) is None
        assert read({"entry": entry}) is None


def test_every_span_metric_is_listed_for_its_cells():
    bench = manifest.Bench(ROOT)
    for cell, names in SPAN_METRICS.items():
        listed = {m["name"] for m in bench.per_layer(cell)}
        assert set(names) <= listed
    assert sum(m["name"] in {n for ns in SPAN_METRICS.values() for n in ns}
               for m in bench.m["per_layer"]) == 11


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SPAN_METRICS))
def test_a_traced_run_reports_each_span_metric(small_root, card, cell):
    bench = manifest.Bench(small_root)
    out = harness.run(bench, cell, 4_000_000_017, 0.5, True,
                      t_start=time.perf_counter(), device=card)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(SPAN_METRICS[cell]) <= set(got)
    assert all(got[m]["value"] >= 0 for m in SPAN_METRICS[cell])
    if cell == "gzip6.read":
        assert got["inflate.device_batches"]["value"] == 4
