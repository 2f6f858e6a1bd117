#!/usr/bin/env python3
"""Smoke run of the tpz_torch gzip encode path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device   the card's name and power limit, torch and CUDA versions
  2. build    nvcc builds the CUDA kernels, g++ the C++ oracle
  3. kernel   the parse-walk kernel against its plain torch version, on
              1 MiB of corpus.mixed and of corpus.repetitive at levels 1
              and 6 (exact equality), then both timed at the headline
              shape (NB = 512 blocks, restart 16384)
  4. slice    tpz_torch.api.compress_many on 2 x 16 MiB of corpus.mixed,
              gzip level 6, device "cuda": bodies equal the oracle's bytes,
              gzip.decompress round-trips, the kernel launched
  5. timing   warm median of 3 iterations on fresh seeds (MB/s), and a
              per-stage split from CUDA events
The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}. Needs the repository checkout around it.
"""

from __future__ import annotations

import gzip
import json
import multiprocessing
import statistics
import subprocess
import sys
import time

import torch

MIB = 1 << 20
HEADLINE_BYTES = 16 * MIB
HEADLINE_BUFFERS = 2
LEVEL = 6
TIMING_ITERS = 3


def _mixed(args):
    from tpz_torch._shared import corpus

    n, seed = args
    return corpus.mixed(n, seed=seed)


def make_corpus(specs):
    """corpus.mixed buffers for (size, seed) pairs, in parallel."""
    with multiprocessing.get_context("spawn").Pool(
            min(len(specs), multiprocessing.cpu_count())) as pool:
        return pool.map(_mixed, specs)


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from tpz_torch import oracle
    from tpz_torch.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    t1 = time.perf_counter()
    oracle.build()
    t2 = time.perf_counter()
    log("build", nvcc_s=f"{t1 - t0:.2f}", gxx_s=f"{t2 - t1:.2f}",
        lib=lib_path)
    with open(lib_path.replace(_build.LIB_NAME, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("build", ptxas=line.strip())


def parse_inputs(datas, cfg, device):
    """The parse walk's inputs for `datas`, built by the pipeline's own
    stages on `device`."""
    from tpz_torch.kernels import deflate_pipeline as dp
    from tpz_torch.kernels import matchfinder as mf

    span, span_off, span_len, block_len, *_ = dp.span_layout(datas)
    words = dp._make_words(torch.from_numpy(span).to(device))
    so = torch.from_numpy(span_off).to(device)
    sln = torch.from_numpy(span_len).to(device)
    bl = torch.from_numpy(block_len).to(device)
    pk1, pk2, cap_at = mf.suffix_screen_w_chunked(
        words, so, sln, cfg.max_chain, mf.WINDOW, mf.BLOCK, mf.MAX_MATCH,
        cfg.screen_bytes, cfg.restart, dp.SCREEN_CHUNK)
    sl = slice(mf.WINDOW, mf.WINDOW + mf.BLOCK)
    return (pk1[:, sl].contiguous(), pk2[:, sl].contiguous(),
            cap_at[:, sl].contiguous(), words, bl)


def _parse_args(cfg):
    from tpz_torch.kernels import matchfinder as mf

    return (mf.WINDOW, mf.MAX_MATCH, cfg.screen_bytes, mf.TOO_FAR, cfg.lazy,
            cfg.max_lazy, cfg.restart, cfg.n_extend)


def timed(fn, reps: int = 1):
    """(last result, mean milliseconds per call over `reps` calls) by
    CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def compare_parse(inputs, cfg):
    """Kernel vs plain on the same CUDA tensors. Returns (max abs
    difference over live positions, which must be 0; kernel ms; plain ms),
    each version timed on its first call."""
    from tpz_torch.kernels import parse

    args = _parse_args(cfg)
    before = parse.parse_extend_v3.launches
    got, ms = timed(lambda: parse.parse_extend_v3(*inputs, *args))
    if parse.parse_extend_v3.launches != before + 1:
        raise RuntimeError("parse walk wrapper did not launch its kernel")
    want, plain_ms = timed(lambda: parse.parse_extend_v3z(
        *inputs, *args, group=inputs[0].shape[0]))
    pos = torch.arange(inputs[0].shape[1], device=inputs[0].device)
    live = pos[None, :] < inputs[4][:, None]
    err = max(int(((g - w).abs() * live).max()) for g, w in zip(got, want))
    if err:
        raise RuntimeError(f"parse kernel disagrees with plain: {err}")
    return err, ms, plain_ms


def phase_kernel(headline):
    from tpz_torch._shared import corpus
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import parse

    small = {"mixed": corpus.mixed(MIB, seed=11),
             "repetitive": corpus.repetitive(MIB, seed=12)}
    for name, data in small.items():
        for level in (1, 6):
            cfg = DeflateConfig(level=level)
            err, _, _ = compare_parse(parse_inputs([data], cfg, "cuda"), cfg)
            log("kernel", input=name, level=level, blocks=16, max_abs_err=err)
    cfg = DeflateConfig(level=LEVEL)
    inputs = parse_inputs(headline, cfg, "cuda")
    err, cold_ms, plain_ms = compare_parse(inputs, cfg)
    args = _parse_args(cfg)
    _, ms = timed(lambda: parse.parse_extend_v3(*inputs, *args), 5)
    log("kernel", input="headline", blocks=inputs[0].shape[0],
        restart=cfg.restart, max_abs_err=err, ms=f"{ms:.3f}",
        first_call_ms=f"{cold_ms:.3f}", plain_ms=f"{plain_ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_slice(batch) -> int:
    from tpz_torch import api, oracle
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import parse

    parse.parse_extend_v3.launches = 0
    t0 = time.perf_counter()
    blobs = api.compress_many(batch, "gzip", level=LEVEL, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = parse.parse_extend_v3.launches
    if launches < 1:
        raise RuntimeError("main path never launched the parse-walk kernel")
    refs = oracle.deflate_encode_many(batch,
                                      DeflateConfig(LEVEL).params_array())
    hdr = gzip_codec.header_bytes(LEVEL)
    for i, (d, blob, ref) in enumerate(zip(batch, blobs, refs)):
        body = blob[len(hdr):-8]
        if not blob.startswith(hdr) or body != ref:
            raise RuntimeError(f"buffer {i}: gzip body differs from oracle")
        if gzip.decompress(blob) != d:
            raise RuntimeError(f"buffer {i}: gzip round trip failed")
    ratio = sum(len(b) for b in blobs) / sum(len(d) for d in batch)
    log("slice", buffers=len(batch), bytes=sum(len(d) for d in batch),
        ratio=f"{ratio:.4f}", cold_s=f"{dt:.3f}", parse_launches=launches,
        oracle_identical=True)
    return launches


def phase_timing(batches, smi) -> None:
    from tpz_torch import api
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import deflate_pipeline as dp

    total = sum(len(d) for d in batches[0])
    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.compress_many(batch, "gzip", level=LEVEL, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = statistics.median(times)
    log("timing", mb_per_s=f"{total / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        card=f"'{smi}'")

    # Per-stage split: a CUDA event after each device stage.
    batch = batches[-1]
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    bodies = dp.compress_many(batch, DeflateConfig(LEVEL), "cuda",
                              stage_hook=hook)
    torch.cuda.synchronize()
    split = {name: events[i][1].elapsed_time(ev)
             for i, (name, ev) in enumerate(events[1:])}
    t0 = time.perf_counter()
    hdr = gzip_codec.header_bytes(LEVEL)
    for d, body in zip(batch, bodies):
        hdr + body + gzip_codec._trailer(d)
    split["host_framing"] = (time.perf_counter() - t0) * 1e3
    log("timing", **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})


def main() -> int:
    import tpz_torch  # noqa: F401 — fails at once outside a checkout

    smi = phase_device()
    phase_build()
    # Seeds as bench.py: 1000, 1001 for the slice, fresh ones per timed
    # iteration.
    nb = HEADLINE_BUFFERS
    specs = [(HEADLINE_BYTES, 1000 + i)
             for i in range(nb * (1 + TIMING_ITERS))]
    t0 = time.perf_counter()
    bufs = make_corpus(specs)
    log("corpus", buffers=len(bufs), seconds=f"{time.perf_counter() - t0:.1f}")
    batches = [bufs[i:i + nb] for i in range(0, len(bufs), nb)]
    kern = phase_kernel(batches[0])
    launches = phase_slice(batches[0])
    phase_timing(batches[1:], smi)
    print(json.dumps({"kernels": [{
        "name": "parse_walk_v3", "route": "cuda",
        "source": "tpz_torch/csrc/parse_walk.cu",
        "replaces": "tpz/kernels/parse.py:464",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
