"""The port's benchmark (port of the reference's bench.py):
`python -m tpz_torch bench`.

Headline: gzip encode throughput of the device pipeline (GB/s per card)
on `corpus.mixed`, the reference's Silesia-like mix: `api.compress_many`
at level 6 on `--buffers` buffers of `--bytes` each, one warm-up batch
(seed 7), then `--iters` timed batches on fresh seeds (1000 + buffers *
i), the median reported. The rows of `extra_metrics` time the rest of the
codec matrix under the reference's names, sizes and seeds. Every time is
host wall time around the call, ending in a synchronize of the card, so
host stages and transfers count; each timed call reads bytes it has not
seen. Before any row the CUDA kernels and the C++ oracle are built (and
their build time reported), so no row pays the build.

Output, on stdout:
  {"detail": {...}}   the headline's times and ratio, every row (MB/s,
                      MB/s of the first call of that shape, its roofline
                      against the card's rates), the measured rates, the
                      build, the card's name and power limit
  {"metric": ...}     the last line, under 1 KB: metric, value (GB/s, or
                      null), unit, vs_baseline (null: no H100 baseline
                      exists), backend (the torch device), card,
                      device_ran, errors and skipped (row names)

`--device cuda` (the default) without a card raises before any row.
`--device cpu` is a smoke run of the same calls on the CPU: it reports
`value: null`, `device_ran: false` and no roofline. A row that raises is
recorded under its name and the command exits 1 after printing both
lines.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import subprocess
import time
import zlib
from functools import partial

import torch

from tpz_torch import api, oracle
from tpz_torch.codecs import bzip2, gzip_codec, lzhuf, zlib_codec
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.kernels import _build
from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.utils import corpus, profiling, roofline

METRIC = "deflate_encode_silesia_like"
LEVEL = 6
MIB = 1 << 20
# The rows that run at most 4 MiB, as the reference's.
ROW_CAP = 4 * MIB


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--bytes", type=int, default=16 * MIB,
                   help="bytes a headline buffer (default 16 MiB)")
    p.add_argument("--buffers", type=int, default=2,
                   help="buffers a headline batch (default 2)")
    p.add_argument("--iters", type=int, default=3,
                   help="timed headline batches (default 3)")
    p.add_argument("--headline-only", action="store_true",
                   help="skip the rows of extra_metrics")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a torch.profiler chrome trace of the timed "
                        "headline batches into DIR")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the codecs run (default: cuda)")


def _mbs(nbytes: float, secs: float) -> float:
    return nbytes / secs / 1e6


def _seconds(fn, device) -> float:
    """Host seconds of fn(), ending in a synchronize of the card."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _mtime(path: str):
    return os.stat(path).st_mtime_ns if os.path.exists(path) else None


def _timed_build(build, lib_path: str) -> dict:
    """Seconds of build(), and whether it compiled or found its cache."""
    before = _mtime(lib_path)
    t0 = time.perf_counter()
    build()
    seconds = time.perf_counter() - t0
    cached = before is not None and _mtime(lib_path) == before
    return {"s": seconds, "cache": "found" if cached else "compiled"}


def build_all(device) -> dict:
    """Builds the oracle and, for a card, the CUDA kernels."""
    out = {"oracle": _timed_build(
        oracle.build, os.path.join(oracle.BUILD_DIR, oracle.LIB_NAME))}
    if device.type == "cuda":
        out["kernels"] = _timed_build(
            _build.build, os.path.join(_build.BUILD_DIR, _build.LIB_NAME))
    return out


def card_power() -> str | None:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None


def _mixed(spec):
    n, seed = spec
    return corpus.mixed(n, seed=seed)


def make_corpus(specs) -> list[bytes]:
    """corpus.mixed buffers for (size, seed) pairs. A 16 MiB buffer takes
    ~25 s of one core, so they are made in parallel processes, one per
    4 MiB of corpus and at most one a core; under 4 MiB in all they are
    made here, as a worker's start (~2 s of imports) would cost more."""
    procs = min(len(specs), os.cpu_count() or 1,
                -(-sum(n for n, _ in specs) // ROW_CAP))
    if procs <= 1:
        return [_mixed(spec) for spec in specs]
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        return pool.map(_mixed, specs)


def extra_metrics(size: int, device, annotate=None):
    """Per-codec encode and decode rows under the reference's names,
    sizes and seeds; one timed call each after, for the device rows, a
    first call timed as MB_s_cold. A row that raises is recorded, never
    fatal; a row whose input could not be made is recorded as skipped.
    `annotate(name, nbytes, mb_s, buffers)` gives a row's roofline."""
    out = {}

    def run(name, nbytes, fn, cold=None, buffers=1):
        """Time fn(); with `cold`, first time cold() (the first call of
        that shape in the process) as MB_s_cold."""
        try:
            row = {}
            if cold is not None:
                row["MB_s_cold"] = _mbs(nbytes, _seconds(cold, device))
            row["MB_s"] = _mbs(nbytes, _seconds(fn, device))
            if annotate is not None:
                rl = annotate(name, nbytes, row["MB_s"], buffers)
                if rl is not None:
                    row["roofline"] = rl
            out[name] = row
        except Exception as e:  # noqa: BLE001 — report, don't crash bench
            out[name] = {"error": f"{type(e).__name__}: {e}"}

    params = DeflateConfig(LEVEL).params_array()
    small = min(size, ROW_CAP)
    specs = {"mix16": (size, 41), "mix16b": (size, 42),
             "gz": (small, 47), "zlib": (small, 48),
             "bdata": (small, 43), "bcold": (small, 45),
             "ldata": (small, 44), "lcold": (small, 46),
             **{("dbatch", i): (small // 2, 60 + i) for i in range(4)},
             **{("lbatch", i): (small // 2, 51 + i) for i in range(4)},
             **{("lbatch2", i): (small // 2, 71 + i) for i in range(4)}}
    data = dict(zip(specs, make_corpus(list(specs.values()))))

    # DEFLATE on the host: the C++ oracle both ways.
    mix16 = data["mix16"]
    mix16b = data["mix16b"]
    blob = oracle.deflate_encode(mix16, params)
    run("deflate_decode_host", size, lambda: oracle.inflate(blob))
    run("deflate_encode_host", size,
        lambda: oracle.deflate_encode(mix16b, params))

    # DEFLATE decode on the device: a TZ-indexed gzip member, four
    # buffers in one batch, and a foreign zlib stream (no side-car).
    gz_blob = gzip_codec.compress(data["gz"], device=device)
    gz = partial(gzip_codec.decompress, gz_blob, device=device)
    run("deflate_decode_device", small, gz, cold=gz)
    dbatch = [data["dbatch", i] for i in range(4)]
    dblobs = api.compress_many(dbatch, "gzip", device=device)
    dm = partial(api.decompress_many, dblobs, "gzip", device=device)
    run("deflate_decode_device_batched", small * 2, dm, cold=dm, buffers=4)
    z_blob = zlib.compress(data["zlib"], 6)
    zd = partial(zlib_codec.decompress, z_blob, device=device)
    run("deflate_decode_device_foreign", small, zd, cold=zd)

    # bzip2: the first encode (seed 45, cold) gives the blob both decode
    # rows read; the warm encode reads fresh bytes. Where the encode
    # failed, the device decode row is skipped and the host decode row
    # reads the oracle's blob of the warm bytes, as in the reference.
    bdata = data["bdata"]
    bcold = data["bcold"]
    bz_blob = {}

    def bz_first():
        bz_blob["c"] = bzip2.compress(bcold, device=device)

    run("bzip2_encode_device", small,
        lambda: bzip2.compress(bdata, device=device), cold=bz_first)
    if "c" in bz_blob:
        bd = partial(bzip2.decompress, bz_blob["c"], device=device)
        run("bzip2_decode_device", small, bd, cold=bd)
    else:
        out["bzip2_decode_device"] = {
            "skipped": "no blob: bzip2_encode_device failed"}
        bz_blob["c"] = oracle.bzip2_encode(bdata, 9)
    run("bzip2_decode_host", small,
        lambda: oracle.bzip2_decode(bz_blob["c"]))

    # LZHUF lh5: encode (cold on seed 46, warm on fresh bytes), batched
    # encode of four half-size buffers, decode of the oracle's stream on
    # the device and on the host.
    ldata = data["ldata"]
    lcold = data["lcold"]
    run("lzhuf_encode_device", small,
        lambda: lzhuf.compress(ldata, "lh5", device=device),
        cold=lambda: lzhuf.compress(lcold, "lh5", device=device))
    lbatch = [data["lbatch", i] for i in range(4)]
    lbatch2 = [data["lbatch2", i] for i in range(4)]
    run("lzhuf_encode_device_batched", small * 2,
        lambda: lzhuf.compress_many(lbatch, "lh5", device=device),
        cold=lambda: lzhuf.compress_many(lbatch2, "lh5", device=device),
        buffers=4)
    bits = lzhuf._dict_bits("lh5")
    lz_body = oracle.lzhuf_encode(ldata, bits, 16)
    lz_blob = lzhuf._container("lh5", ldata, lz_body)
    ld = partial(lzhuf.decompress, lz_blob, device=device)
    run("lzhuf_decode_device", small, ld, cold=ld)
    run("lzhuf_decode_host", small,
        lambda: oracle.lzhuf_decode(lz_body, small, bits))
    return out


def headline(size: int, nbuf: int, iters: int, device, trace_dir=None):
    """gzip encode of nbuf buffers a batch: the warm-up batch's ratio and
    the timed batches' seconds."""
    def encode(batch):
        return api.compress_many(batch, "gzip", LEVEL, device=device)

    seeds = [7] + [1000 + nbuf * i for i in range(iters)]
    bufs = make_corpus([(size, seed + j) for seed in seeds
                        for j in range(nbuf)])
    warm, *batches = [bufs[i:i + nbuf] for i in range(0, len(bufs), nbuf)]
    total = size * nbuf
    ratio = sum(len(o) for o in encode(warm)) / total
    trace = (profiling.trace(trace_dir, device) if trace_dir
             else contextlib.nullcontext())
    times = []
    with trace:
        for batch in batches:
            times.append(_seconds(lambda: encode(batch), device))
    median = sorted(times)[len(times) // 2]
    return {"bytes": total, "buffers": nbuf, "bytes_per_buffer": size,
            "level": LEVEL, "median_s": median, "all_s": times,
            "compression_ratio": ratio, "GB_s": total / median / 1e9}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpz_torch bench",
                                description="time the port's codecs")
    add_arguments(p)
    args = p.parse_args(argv)
    device = _device(args.device)  # no card for "cuda": raises here
    on_card = device.type == "cuda"
    detail = {"device": str(device), "build": build_all(device)}
    annotate = None
    if on_card:
        card = torch.cuda.get_device_name(0)
        rates = roofline.measure_rates(device)
        detail.update(card=card, card_power=card_power(), rates=rates)
        if roofline.peaks(card) is None:
            detail["roofline"] = f"no peaks for {card!r} in roofline.PEAKS"

        def annotate(name, nbytes, mb_s, buffers=1):
            return roofline.annotate(name, nbytes, mb_s, buffers=buffers,
                                     rates=rates, card=card)

    head = headline(args.bytes, args.buffers, args.iters, device,
                    args.trace)
    rl = annotate and annotate("deflate_encode_device", head["bytes"],
                               head["GB_s"] * 1e3, args.buffers)
    if rl:
        head["roofline"] = rl
    detail["headline"] = head
    rows = ({} if args.headline_only else
            extra_metrics(args.bytes, device, annotate))
    detail["extra_metrics"] = rows
    print(json.dumps({"detail": detail}), flush=True)
    errors = [name for name, row in rows.items() if "error" in row]
    print(json.dumps({
        "metric": METRIC,
        # A run that never touched the card reports no value.
        "value": head["GB_s"] if on_card else None,
        "unit": "GB/s/chip",
        "vs_baseline": None,
        "backend": device.type,
        "card": detail.get("card"),
        "device_ran": on_card,
        "errors": errors,
        "skipped": [name for name, row in rows.items() if "skipped" in row],
    }), flush=True)
    return 1 if errors else 0
