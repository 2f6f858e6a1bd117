"""The yardstick's own arithmetic: the content generator, the trace
arithmetic (idle union, launches by correlation id, kernel time, gaps),
the least-bytes count and the peak table, on hand-made inputs."""

import zlib

import numpy as np
import pytest

from benchmark import corpus, readers, traceops, work
from benchmark.traceops import Event

SHARES = [["text", 3], ["source", 4], ["repetitive", 6], ["random", 8],
          ["skewed", 8]]
CONTENT = {"shares": SHARES, "fill": "text"}


def test_pool_is_deterministic_per_seed():
    a = corpus.pool(3_000_000_017, 3, 50_000, CONTENT)
    assert a == corpus.pool(3_000_000_017, 3, 50_000, CONTENT)
    assert corpus.pool(3_000_000_017, 1, 50_000, CONTENT) == a[:1]
    assert corpus.pool(3_000_000_018, 3, 50_000, CONTENT) != a
    assert len(set(a)) == 3 and all(len(o) == 50_000 for o in a)


def test_mixed_keeps_the_classes_in_order_and_share():
    n = 240_000
    obj = corpus.mixed(n, np.random.default_rng(7), SHARES, "text")
    rng = np.random.default_rng(7)
    parts = [corpus.CLASSES[c](n // d, rng) for c, d in SHARES]
    parts.append(corpus.text(n - sum(map(len, parts)), rng))
    assert obj == b"".join(parts)
    assert [len(p) for p in parts[:5]] == [n // d for _, d in SHARES]


@pytest.mark.parametrize("name", sorted(corpus.CLASSES))
def test_each_class_compresses_as_the_ports_copy_does(name):
    from tpz_torch.utils import corpus as port

    theirs = {"text": port.text, "source": port.source_code,
              "repetitive": port.repetitive, "random": port.random_bytes,
              "skewed": port.skewed_bytes}[name](1 << 18, 11)
    ours = corpus.CLASSES[name](1 << 18, np.random.default_rng(11))

    def pct(b):
        return 100 * len(zlib.compress(b, 6)) / len(b)

    assert len(ours) == 1 << 18
    assert abs(pct(ours) - pct(theirs)) < 1.0


def test_text_is_words_in_lines():
    t = corpus.text(100_000, np.random.default_rng(3))
    lines = t.split(b"\n")[:-1]
    assert all(60 <= len(x) <= 90 for x in lines)
    letters = b"abcdefghijklmnopqrstuvwxyz"
    assert set(t) <= set(letters + letters.upper() + b" .\n")


def ev(name, cat, ts, dur, corr):
    return Event(name, cat, float(ts), float(dur), corr)


# A stretch [100, 300] us: three launches in it (ids 1-3), one before it
# (id 9); the device runs kernel 1 over [110, 150], the memcpy 2 over
# [140, 170] (overlapping it), kernel 3 over [250, 260]; id 9's kernel
# ran at [50, 90]. Host: a cpu op over [175, 245].
EVENTS = [
    ev("benchmark.profiled", "user_annotation", 100, 200, 0),
    ev("cudaLaunchKernel", "cuda_runtime", 105, 2, 1),
    ev("cudaMemcpyAsync", "cuda_runtime", 120, 2, 2),
    ev("cudaLaunchKernel", "cuda_runtime", 240, 2, 3),
    ev("cudaLaunchKernel", "cuda_runtime", 40, 2, 9),
    ev("cudaStreamSynchronize", "cuda_runtime", 150, 20, 4),
    ev("k1", "kernel", 110, 40, 1),
    ev("Memcpy DtoH", "gpu_memcpy", 140, 30, 2),
    ev("k3", "kernel", 250, 10, 3),
    ev("k9", "kernel", 50, 40, 9),
    ev("aten::sort", "cpu_op", 175, 70, 50),
]


def test_launched_takes_the_stretchs_device_work_by_correlation_id():
    t0, t1 = traceops.span_of(EVENTS, "benchmark.profiled")
    assert (t0, t1) == (100.0, 300.0)
    dev = traceops.launched(EVENTS, t0, t1)
    assert sorted(e.name for e in dev) == ["Memcpy DtoH", "k1", "k3"]
    assert traceops.missing_launches(EVENTS, t0, t1) == []
    assert traceops.busy_intervals(dev) == [(110.0, 170.0), (250.0, 260.0)]
    assert traceops.busy_us(dev) == 70.0
    assert traceops.kernel_us(dev) == 50.0
    assert traceops.top_ops(dev) == [["k1", 40e-6], ["Memcpy DtoH", 30e-6],
                                     ["k3", 10e-6]]


def test_a_launch_without_its_device_event_is_missing():
    events = [e for e in EVENTS if e.name != "k3"]
    assert traceops.missing_launches(events, 100, 300) == ["cudaLaunchKernel"]


def test_idle_gaps_are_named_by_the_host_op_and_the_next_device_op():
    dev = traceops.launched(EVENTS, 100, 300)
    gaps = traceops.idle_gaps(EVENTS, dev, 100, 300)
    assert gaps == [["aten::sort, before k3", 80e-6],
                    ["no torch op, before the stretch's end", 40e-6],
                    ["no torch op, before k1", 10e-6]]


def record(entry, least_bytes, hbm, events=EVENTS, complete=True):
    dev = traceops.launched(events, 100, 300)
    return {"entry": entry, "profile": {
        "events": events, "t0": 100.0, "t1": 300.0, "device": dev,
        "complete": complete, "least_bytes": least_bytes,
        "hbm_bytes_per_s": hbm}}


def test_idle_share_and_roofline_on_hand_made_events():
    rec = record(readers.ENCODE, least_bytes=1_000_000, hbm=1e12)
    assert readers.idle_pct(rec, readers.ENCODE) == pytest.approx(65.0)
    # 1 MB at 1 TB/s is 1 us of least time, over 50 us of kernels.
    assert readers.roofline_pct(rec, readers.ENCODE) == pytest.approx(2.0)
    assert readers.idle_pct(rec, readers.DECODE) is None
    assert readers.roofline_pct(rec, readers.DECODE) is None


def test_no_reading_from_an_incomplete_trace_or_an_unknown_card():
    rec = record(readers.ENCODE, 1_000_000, 1e12, complete=False)
    assert readers.idle_pct(rec, readers.ENCODE) is None
    assert readers.roofline_pct(rec, readers.ENCODE) is None
    rec = record(readers.ENCODE, 1_000_000, None)
    assert readers.roofline_pct(rec, readers.ENCODE) is None


def test_least_bytes_and_peaks():
    assert work.least_bytes([b"ab", b"cde"], [b"x"]) == 6
    assert work.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert work.hbm_bytes_per_s("NVIDIA A100-SXM4-80GB") is None


def test_stage_medians_and_self_time():
    rec = {"entry": readers.ENCODE, "stage_walls_s": [0.066, 0.080, 0.070],
           "stages": [{"screen": 60.0, "bitpack": 2.0, "plan": 1.0},
                      {"screen": 70.0, "bitpack": 3.0},
                      {"screen": 64.0, "bitpack": 2.5, "plan": 1.5}]}
    assert readers.stage_ms(rec, ["screen"]) == 64.0
    assert readers.stage_ms(rec, ["bitpack", "plan"]) == 3.0
    assert readers.stage_ms(rec, ["bwt"]) is None
    # wall less stages: 3, 7 and 2 ms.
    assert readers.self_ms(rec, readers.ENCODE) == pytest.approx(3.0)
    assert readers.self_ms(rec, readers.DECODE) is None
