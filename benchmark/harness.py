"""One run of one cell: set-up, the measured window, the traced stretch,
the check, the result line.

A cell pairs a configuration (format, level, content, reference, the
program's counters and hooked entries) with a traffic mix (the api entry
it drives, objects a request, object size, pool). Set-up makes the pool
from the seed, writes the read cells' streams with the stock library,
and sends every request of one rotation of the pool through the entry
once. The window is a closed loop: one client, one request in flight,
the pool's requests in rotation, until `seconds` have passed. With
`trace`, the window is followed by one rotation through the hooked entry
(stage times from CUDA events at the program's stage hooks) and one
rotation under `torch.profiler` (device events, without the hooks). Then
every output is held to the reference, and each metric's reader reads
the record.
"""

from __future__ import annotations

import importlib
import os
import statistics
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

from benchmark import corpus, stages, traceops, work

FORBIDDEN = ("jax", "jaxlib", "flax", "tpz")
PROFILE_LABEL = "benchmark.profiled"
# Host time the profiled session idles after the profiled requests; it
# runs one rotation of requests before them. Without such margins traces
# lost a call's first or last kernels (chip_smoke.TRACE_MARGIN_S), and
# the profiled session's first requests run slower than later ones.
TRACE_MARGIN_S = 0.05
PROFILE_TRIES = 3


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def resolve(dotted: str):
    """The object that "package.module:attribute" names."""
    mod, _, attr = dotted.partition(":")
    return getattr(importlib.import_module(mod), attr)


class Card:
    """The device the program runs on. Only the tests hand the harness
    "cpu" (run.py exits without a card): then nothing is synchronised and
    no device number is read."""

    def __init__(self, device: str):
        import torch

        self.torch = torch
        self.gpu = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.gpu:
            self.torch.cuda.synchronize()

    def info(self, chips: int) -> dict:
        if not self.gpu:
            return {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
        torch = self.torch
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}


def program_entries(cfg: dict, entry: str, device: str):
    """(api call, hooked call) for the traffic's entry: the api call takes
    a request's inputs; the hooked one also a stage hook."""
    from tpz_torch import api

    fmt, level = cfg["format"], cfg["level"]
    hooked = resolve(cfg["hooked"][entry])
    if entry == "compress_many":
        return (lambda batch: api.compress_many(batch, fmt, level,
                                                device=device),
                lambda batch, hook: hooked(batch, level, device=device,
                                           stage_hook=hook))
    if entry == "decompress_many":
        return (lambda batch: api.decompress_many(batch, fmt, device=device),
                lambda batch, hook: hooked(batch, device=device,
                                           stage_hook=hook))
    raise ValueError(f"unknown entry {entry!r}")


def counters(cfg: dict) -> dict:
    """The program's counters that the configuration names, now."""
    return {c: resolve(c) for c in cfg.get("counters", [])}


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


class Cell:
    """A cell's inputs: the pool, what the entry takes, and the requests
    (pool indices) of one rotation."""

    def __init__(self, bench, name: str, seed: int):
        self.spec = bench.cell(name)
        self.cfg = bench.config(self.spec["config"])
        self.traffic = bench.traffic(self.spec["traffic"])
        self.entry = self.traffic["entry"]
        self.ref = importlib.import_module(
            f"benchmark.reference.{self.cfg['reference']}")
        t = self.traffic
        self.objs = corpus.pool(seed, t["pool_objects"], t["object_bytes"],
                                self.cfg["content"])
        if self.entry == "decompress_many":
            self.inputs = self._streams()
        else:
            self.inputs = self.objs
        k = t["objects_per_request"]
        self.rotation = [list(range(i, i + k))
                         for i in range(0, len(self.objs) - k + 1, k)]

    def _streams(self) -> list[bytes]:
        """The read traffic's streams: each object written by the
        reference's stock writer (in threads)."""
        level = self.cfg["level"]
        workers = min(len(self.objs), os.cpu_count() or 1)
        with ThreadPoolExecutor(workers) as ex:
            return list(ex.map(lambda d: self.ref.encode(d, level),
                               self.objs))

    def batch(self, idx) -> list[bytes]:
        return [self.inputs[i] for i in idx]


def _call(fn, card, batch):
    """(result or the exception it raised, seconds), the device
    synchronised before the clock stops."""
    t0 = time.perf_counter()
    try:
        out = fn(batch)
        card.sync()
    except Exception as e:  # a failed request is counted, not fatal
        out = e
    return out, time.perf_counter() - t0


def window(api_call, card, cell: Cell, seconds: float):
    """The closed loop. Returns (done: [(pool indices, result)],
    latencies, window seconds)."""
    done, lat = [], []
    rot = cell.rotation
    t_start = time.perf_counter()
    r = 0
    while True:
        idx = rot[r % len(rot)]
        out, dt = _call(api_call, card, cell.batch(idx))
        done.append((idx, out))
        lat.append(dt)
        r += 1
        if time.perf_counter() - t_start >= seconds:
            return done, lat, time.perf_counter() - t_start


def hooked_splits(api_call, hooked_call, card, cell: Cell):
    """For each request of one rotation: its wall time through the api
    entry, then its stage times through the hooked entry, right after
    on the same inputs."""
    splits, walls, done = [], [], []
    for idx in cell.rotation:
        out, dt = _call(api_call, card, cell.batch(idx))
        done.append((idx, out))
        walls.append(dt)
        split, out = stages.stage_split(
            lambda hook: hooked_call(cell.batch(idx), hook))
        splits.append(split)
        done.append((idx, out))
    return splits, walls, done


def profiled(api_call, card, cell: Cell) -> tuple[dict, list]:
    """One rotation of api calls under torch.profiler, after a rotation
    in the same session that is not read, its events read in memory.
    Tried again (at most PROFILE_TRIES times) while the trace lacks the
    device event of a launch the rotation made."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    done = []
    for attempt in range(PROFILE_TRIES):
        card.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for idx in cell.rotation:
                done.append((idx, api_call(cell.batch(idx))))
                card.sync()
            part, walls = [], []
            with torch.profiler.record_function(PROFILE_LABEL):
                for idx in cell.rotation:
                    t = time.perf_counter()
                    part.append((idx, api_call(cell.batch(idx))))
                    card.sync()
                    walls.append(time.perf_counter() - t)
            time.sleep(TRACE_MARGIN_S)
        t_read = time.perf_counter()
        events = traceops.from_profiler(prof, (PROFILE_LABEL,))
        t0, t1 = traceops.span_of(events, PROFILE_LABEL)
        missing = traceops.missing_launches(events, t0, t1)
        done += part
        cats = {}
        for e in events:
            cats[e.cat] = cats.get(e.cat, 0) + 1
        log(f"profile try {attempt + 1}: events by kind {cats}; request "
            f"ms {[round(w * 1e3, 1) for w in walls]}")
        log(f"profile try {attempt + 1}: {len(events)} events read in "
            f"{time.perf_counter() - t_read:.2f} s; launches without a "
            f"device event: {len(missing)} {sorted(set(missing))[:5]}")
        if not missing:
            break
    dev = traceops.launched(events, t0, t1)
    least = sum(work.least_bytes(cell.batch(idx), out) for idx, out in part)
    return {"events": events, "t0": t0, "t1": t1, "device": dev,
            "complete": not missing, "least_bytes": least}, done


def check(cell: Cell, done, window_requests: int) -> dict:
    """Every output against the reference. Archive cells: each stream
    decoded by the strict stock reader to its object (a stream equal to
    one already verified for the same object is that stream again, and
    is not decoded twice). Read cells: every byte against the object.
    Returns the count of wrong objects, the objects checked, the failed
    requests, and the stored bytes of the window's streams."""
    objs = cell.objs
    uniq = {}  # object index -> distinct streams returned for it
    for idx, out in done:
        if isinstance(out, list) and len(out) == len(idx):
            for i, s in zip(idx, out):
                if (cell.entry == "compress_many" and isinstance(s, bytes)
                        and not any(s == u for u in uniq.setdefault(i, []))):
                    uniq[i].append(s)

    def restores(pair):
        i, s = pair
        try:
            return cell.ref.decode(s) == objs[i]
        except Exception:  # any failure of the stock reader is a wrong stream
            return False

    pairs = [(i, s) for i, ss in uniq.items() for s in ss]
    with ThreadPoolExecutor(8) as ex:
        ok = dict(zip(((i, id(s)) for i, s in pairs), ex.map(restores, pairs)))

    def good(i, s):
        if cell.entry == "decompress_many":
            return s == objs[i]
        return isinstance(s, bytes) and any(
            s == u and ok[(i, id(u))] for u in uniq.get(i, []))

    wrong = checked = failed = 0
    stored = plain = 0
    for r, (idx, out) in enumerate(done):
        checked += len(idx)
        if not isinstance(out, list) or len(out) != len(idx):
            wrong += len(idx)
            failed += 1
            continue
        bad = sum(not good(i, s) for i, s in zip(idx, out))
        wrong += bad
        failed += bad > 0
        if r < window_requests and not bad and cell.entry == "compress_many":
            stored += sum(len(s) for s in out)
            plain += sum(len(objs[i]) for i in idx)
    return {"wrong": wrong, "checked": checked, "failed": failed,
            "stored_bytes": stored, "stored_plain_bytes": plain}


def run(bench, workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", entries=None) -> dict:
    """One run; returns the result line's object. `entries` (api call,
    hooked call) stands in for the program's, for the tests' faults and
    the controls."""
    card = Card(device)
    log(f"set-up: imports done at {time.perf_counter() - t_start:.2f} s")
    cell = Cell(bench, workload, seed)
    log(f"set-up: inputs made at {time.perf_counter() - t_start:.2f} s")
    log(f"cell {workload}: {cell.entry} of {len(cell.rotation[0])} objects "
        f"a request, pool {len(cell.objs)} ({sum(map(len, cell.objs))} "
        f"bytes), seed {seed}")
    api_call, hooked_call = entries or program_entries(
        cell.cfg, cell.entry, device)
    before = counters(cell.cfg)
    for idx in cell.rotation:  # warm-up: every request of the window once
        _call(api_call, card, cell.batch(idx))
    setup_s = time.perf_counter() - t_start

    done, lat, window_s = window(api_call, card, cell, seconds)
    n_window = len(done)
    ms = sorted(x * 1e3 for x in lat)
    log(f"window: {n_window} requests in {window_s:.3f} s; latency ms "
        f"min {ms[0]:.1f}, median {statistics.median(ms):.1f}, "
        f"max {ms[-1]:.1f}")
    log("counters before and after the window:",
        {k: [v, resolve(k)] for k, v in before.items()})

    record = {"cell": cell.spec, "config": cell.cfg, "traffic": cell.traffic,
              "entry": cell.entry, "setup_s": setup_s}
    result_device = {}
    breakdown = None
    if trace:
        splits, walls, more = hooked_splits(api_call, hooked_call, card,
                                            cell)
        done += more
        prof, more = profiled(api_call, card, cell)
        done += more
        record["stages"] = splits
        record["stage_walls_s"] = walls
        record["profile"] = prof
        wall = prof["t1"] - prof["t0"]
        result_device = {"busy_s": traceops.busy_us(prof["device"]) / 1e6,
                         "window_s": wall / 1e6}
        breakdown = {"device_ops": traceops.top_ops(prof["device"]),
                     "idle_gaps": traceops.idle_gaps(
                         prof["events"], prof["device"], prof["t0"],
                         prof["t1"])}
    info = card.info(cell.spec["chips"])
    if trace:
        prof["hbm_bytes_per_s"] = work.hbm_bytes_per_s(info["kind"])

    failure = next((o for _, o in done if isinstance(o, Exception)), None)
    if failure is not None:
        log("a request raised:",
            "".join(traceback.format_exception(failure)))
    t_check = time.perf_counter()
    got = check(cell, done, n_window)
    log(f"check: {time.perf_counter() - t_check:.2f} s")
    plain = sum(len(cell.objs[i]) for idx, out in done[:n_window]
                if isinstance(out, list) for i in idx)
    record["window"] = {"seconds": window_s, "latencies_s": lat,
                        "requests": n_window, "plain_bytes": plain,
                        "stored_bytes": got["stored_bytes"],
                        "stored_plain_bytes": got["stored_plain_bytes"]}
    correct = got["wrong"] == 0

    wanted = bench.per_layer(workload) if trace else bench.end_to_end(workload)
    metrics = {}
    for m in wanted:
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {"wrong_objects": {"value": got["wrong"], "limit": 0}}
    log(f"objects checked: {got['checked']}, requests failed: "
        f"{got['failed']}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules loaded that the run may not load: {found}")
    out = {"correct": correct, "attempted": len(done),
           "failed": got["failed"], "metrics": metrics,
           "device": {**info, **result_device}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
