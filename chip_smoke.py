#!/usr/bin/env python3
"""Smoke run of the tpz_torch gzip encode and decode paths on one NVIDIA
GPU.

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
  6. decode-kernels
              the symbol-walk kernel against its plain torch version
              (exact markers) and the copy-machine kernel against the
              plain doubling resolve (exact bytes): 1 MiB of
              corpus.mixed and of corpus.repetitive on the TZ-indexed and
              the segmented route; a match-heavy synthetic marker stream
              (dist 1-4 runs) with dist_bias 0 and 1; then at 16 MiB a
              TZ-indexed member and the segmented layout of a phase-4
              gzip body (the headline dispatch's own input), both kernels
              timed there beside their plain versions (the copy machine's
              launch alone and through its wrapper)
  7. decode-slice
              api.decompress_many on the 2 x 16 MiB gzip blobs of phase 4,
              api.decompress on a 16 MiB TZ-indexed member, a stdlib gzip
              and a stdlib zlib stream, device "cuda": every output equals
              its input; on each of the four paths, with the counts set to
              0 just before it, both decode kernels launched and nothing
              declined to the host
  8. decode-timing
              warm median of 3 decompress_many calls on the 2 x 16 MiB
              batch (MB/s of plaintext) and a per-stage split from CUDA
              events, with the host CRC time
A JSON record of the kernels (launches from the headline decode batch,
times at the headline shapes) comes before the card's name and power
limit; the last line is
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
import zlib

import numpy as np
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


def phase_kernel(headline, small):
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import parse

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


def phase_slice(batch):
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
    return launches, blobs


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


def indexed_inputs(data):
    """The device layout of `data` encoded by the port with its TZ block
    index, built by the decode pipeline's own host stages."""
    from tpz_torch import oracle
    from tpz_torch.codecs import deflate
    from tpz_torch.kernels import inflate_pipeline as ip

    items = [deflate.compress_indexed(data, device="cuda")]
    scans = {0: oracle.inflate_scan_headers(items[0][0], items[0][1])}
    return ip._to_device(ip._indexed_layout(items, [0], scans), "cuda")


def segmented_inputs(raw):
    """The device layout of the raw DEFLATE stream `raw` on the segmented
    route (host segment index, ragged out_lens, split-match carries), as
    the decode pipeline's own host stages build it."""
    from tpz_torch import oracle
    from tpz_torch.kernels import inflate_pipeline as ip

    idx = ip.index_stream(raw)
    scans = {0: oracle.inflate_scan_segments(
        raw, idx["hdr_bits"], idx["seg_bits"], idx["end_bits"])}
    return ip._to_device(ip._segmented_layout([(raw, idx)], [0], scans),
                         "cuda")


def dense_markers(t, markers):
    """The resolve's input: the walk's markers materialized and (on the
    segmented route) placed into dense output space."""
    from tpz_torch.kernels import inflate_pipeline as ip

    segmented = "dense_off" in t
    m = ip._materialize_fn(markers, *ip._materialize_args(t),
                           carry=t["carry"] if segmented else None)
    return ip._place_dense(m, t) if segmented else m.reshape(-1)


def compare_walk(t):
    """Symbol-walk kernel vs plain on the same CUDA tensors: (markers,
    max abs difference, kernel ms, plain ms), each timed on its first
    call. Raises unless the markers are equal."""
    from tpz_torch.kernels import inflate_pipeline as ip

    args = ip._walk_args(t)
    before = ip.symbol_walk.launches
    got, ms = timed(lambda: ip.symbol_walk(*args))
    if ip.symbol_walk.launches != before + 1:
        raise RuntimeError("symbol walk wrapper did not launch its kernel")
    want, plain_ms = timed(lambda: ip.symbol_walk_plain(*args))
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise RuntimeError(f"symbol-walk kernel disagrees with plain: {err}")
    return got, err, ms, plain_ms


def compare_resolve(dense, dist_bias=0):
    """Copy machine (resolve_dense on a CUDA tensor) vs the plain doubling
    resolve over the whole span: max abs byte difference, which must be
    0."""
    from tpz_torch.kernels import resolve_walk as rw

    before = rw.resolve_copy_machine.launches
    got = rw.resolve_dense(dense, dist_bias)
    if rw.resolve_copy_machine.launches == before:
        raise RuntimeError("copy-machine wrapper did not launch its kernel")
    want = rw.resolve_doubling_state(dense, dist_bias) & 0xFF
    err = int((got.to(torch.int64) - want).abs().max())
    if err:
        raise RuntimeError(f"copy-machine kernel disagrees with plain: {err}")
    return err


def synthetic_markers(n, dist_bias, seed):
    """A match-heavy marker stream: a literal, then a 258-byte match, over
    and over; 70% of the matches are dist 1-4 runs (self-overlap), the
    rest reach back up to 32 KiB (across phase-1 segments)."""
    rng = np.random.default_rng(seed)
    g = n // 259
    m = np.full(n, 1 << 28, np.int64)
    lit = np.arange(g) * 259
    m[lit] = (1 << 28) | rng.integers(0, 256, g)
    pos = lit + 1
    far = rng.random(g) < 0.3
    dist = np.where(far, 1 + (rng.random(g) * np.minimum(pos, 32768)).astype(
        np.int64), rng.integers(1, 5, g))
    m[pos] = (2 << 28) | ((dist - dist_bias) << 9) | 258
    m[(pos[:, None] + np.arange(1, 258)).reshape(-1)] = 0
    return torch.from_numpy(m.astype(np.int32)).cuda()


def phase_decode_kernels(small, big, body):
    """`big` is 16 MiB of plaintext for the TZ-indexed route; `body` is the
    raw DEFLATE body of one phase-4 gzip blob, whose segmented layout is
    what the headline decode dispatch gives both kernels."""
    from tpz_torch.kernels import inflate_pipeline as ip
    from tpz_torch.kernels import resolve_walk as rw

    err_w = err_r = 0
    for name, data in small.items():
        for route, t in (("indexed", indexed_inputs(data)),
                         ("segmented", segmented_inputs(
                             zlib.compress(data, 6)[2:-4]))):
            markers, e, _, _ = compare_walk(t)
            err_w = max(err_w, e)
            err_r = max(err_r, compare_resolve(dense_markers(t, markers)))
            log("decode-kernels", input=name, route=route,
                entries=t["out_len"].shape[0], walk_max_abs_err=e,
                resolve_max_abs_err=err_r)
    for bias in (0, 1):
        m = synthetic_markers(rw.PHASE2_CAP + (1 << 20), bias, 7 + bias)
        err_r = max(err_r, compare_resolve(m, bias))
        log("decode-kernels", input="synthetic-runs", positions=m.shape[0],
            dist_bias=bias, resolve_max_abs_err=err_r)

    for name, t in (("16MiB-indexed", indexed_inputs(big)),
                    ("16MiB-segmented-headline", segmented_inputs(body))):
        markers, e, cold_ms, walk_plain_ms = compare_walk(t)
        err_w = max(err_w, e)
        args = ip._walk_args(t)
        _, walk_ms = timed(lambda: ip.symbol_walk(*args), 5)
        dense = dense_markers(t, markers)
        err_r = max(err_r, compare_resolve(dense))
        # The copy machine at the shape the main path gives it: the first
        # PHASE2_CAP chunk of the 16 MiB span. `ms` is its launch alone on
        # prepared inputs; the wrapper adds the boundary carries and pad.
        chunk = dense[:rw.PHASE2_CAP].contiguous()
        prep = rw._prepare(chunk, 0, rw.SEGMENT_ROWS)
        rw._launch(*prep)
        _, res_ms = timed(lambda: rw._launch(*prep), 5)
        _, wrap_ms = timed(lambda: rw.resolve_copy_machine(chunk), 5)
        rw.resolve_doubling_state(chunk)
        _, res_plain_ms = timed(lambda: rw.resolve_doubling_state(chunk), 3)
        _, dense_ms = timed(lambda: rw.resolve_dense(dense), 3)
        _, dense_plain_ms = timed(lambda: rw.resolve_doubling_state(dense), 3)
        log("decode-kernels", input=name, entries=args[0].shape[0],
            positions=dense.shape[0], walk_max_abs_err=e,
            resolve_max_abs_err=err_r, walk_ms=f"{walk_ms:.3f}",
            walk_first_call_ms=f"{cold_ms:.3f}",
            walk_plain_ms=f"{walk_plain_ms:.3f}",
            resolve_chunk_ms=f"{res_ms:.3f}",
            resolve_chunk_wrapper_ms=f"{wrap_ms:.3f}",
            resolve_chunk_plain_ms=f"{res_plain_ms:.3f}",
            resolve_16MiB_ms=f"{dense_ms:.3f}",
            resolve_16MiB_plain_ms=f"{dense_plain_ms:.3f}")
    # The kernels line keeps the headline input's times (the last one).
    return ({"max_abs_err": err_w, "ms": walk_ms, "plain_ms": walk_plain_ms},
            {"max_abs_err": err_r, "ms": res_ms, "plain_ms": res_plain_ms})


def drive_decode(path, fn, want):
    """One decode path with both kernels' counts set to 0 just before it
    and read just after; raises unless it returns `want`, launched both
    kernels and declined nothing to the host. Returns its counts."""
    from tpz_torch.kernels import inflate_pipeline as ip
    from tpz_torch.kernels import resolve_walk as rw

    declines = ip.host_declines
    ip.symbol_walk.launches = 0
    rw.resolve_copy_machine.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"walk": ip.symbol_walk.launches,
                "resolve": rw.resolve_copy_machine.launches}
    if out != want:
        raise RuntimeError(f"{path}: decode did not return its input")
    if min(launches.values()) < 1:
        raise RuntimeError(f"{path}: decode path skipped a kernel: "
                           f"{launches}")
    if ip.host_declines != declines:
        raise RuntimeError(f"{path}: decode declined to the host inflate")
    log("decode-slice", path=path, cold_s=f"{dt:.3f}",
        walk_launches=launches["walk"], resolve_launches=launches["resolve"],
        host_declines=0, identical=True)
    return launches


def phase_decode_slice(batch, blobs):
    """The decode main path and the three other entry paths, each with
    launch counts of its own; returns the headline batch's counts."""
    from tpz_torch import api

    tz = api.compress(batch[0], "gzip", device="cuda")
    foreign = {"gzip": gzip.compress(batch[1], 6),
               "zlib": zlib.compress(batch[1], 6)}
    launches = drive_decode(
        "batch-2x16MiB",
        lambda: api.decompress_many(blobs, "gzip", device="cuda"), batch)
    drive_decode("tz-member-16MiB",
                 lambda: api.decompress(tz, "gzip", device="cuda"), batch[0])
    for fmt, blob in foreign.items():
        drive_decode(f"stdlib-{fmt}-16MiB",
                     lambda: api.decompress(blob, fmt, device="cuda"),
                     batch[1])
    return launches


def phase_decode_timing(batch, blobs, smi) -> None:
    from tpz_torch import api
    from tpz_torch.codecs import gzip_codec

    total = sum(len(d) for d in batch)
    times = []
    for _ in range(TIMING_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decompress_many(blobs, "gzip", device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    median = statistics.median(times)
    log("decode-timing", mb_per_s=f"{total / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        card=f"'{smi}'")

    # Per-stage split: a CUDA event after each stage, summed over buffers.
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    gzip_codec.decompress_many(blobs, device="cuda", stage_hook=hook)
    torch.cuda.synchronize()
    split = {}
    for (_, prev), (name, ev) in zip(events, events[1:]):
        split[name] = split.get(name, 0.0) + prev.elapsed_time(ev)
    t0 = time.perf_counter()
    for d in batch:
        zlib.crc32(d)
    split["host_crc"] = (time.perf_counter() - t0) * 1e3
    log("decode-timing", **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})


def main() -> int:
    import tpz_torch  # noqa: F401 — fails at once outside a checkout
    from tpz_torch._shared import corpus
    from tpz_torch.codecs import gzip_codec

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
    small = {"mixed": corpus.mixed(MIB, seed=11),
             "repetitive": corpus.repetitive(MIB, seed=12)}
    kern = phase_kernel(batches[0], small)
    launches, blobs = phase_slice(batches[0])
    phase_timing(batches[1:], smi)
    hdr_len = len(gzip_codec.header_bytes(LEVEL))
    walk, resolve = phase_decode_kernels(small, batches[0][0],
                                         blobs[0][hdr_len:-8])
    dec = phase_decode_slice(batches[0], blobs)
    phase_decode_timing(batches[0], blobs, smi)
    rows = [("parse_walk_v3", "parse_walk.cu", "tpz/kernels/parse.py:464",
             launches, kern),
            ("symbol_walk", "symbol_walk.cu",
             "tpz/kernels/inflate_pipeline.py:55", dec["walk"], walk),
            ("resolve_copy_machine", "resolve_walk.cu",
             "tpz/kernels/resolve_walk.py:91", dec["resolve"], resolve)]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"tpz_torch/csrc/{src}",
        "replaces": where, "launches": n, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}
        for name, src, where, n, k in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
