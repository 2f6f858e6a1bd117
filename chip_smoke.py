#!/usr/bin/env python3
"""Smoke run of the tpz_torch gzip, LZHUF and bzip2 encode and decode
paths, and of the two parse functions no codec path reaches, on one
NVIDIA GPU.

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
  9. lzhuf-kernels
              the v1 parse-walk kernel against its plain torch version
              (exact reach and lengths) on the blocks of 1 MiB of
              corpus.mixed at lh5 and lh7 and on the headline batch's
              blocks at lh5; the LZHUF token-walk kernel against its plain
              version (exact markers) and the copy machine at dist_bias 1
              against the plain resolve (exact bytes) on the segmented
              layout of 1 MiB lh5 and lh7 streams and of a 16 MiB lh5
              stream of the headline batch; each kernel timed beside its
              plain version at the headline shape
 10. lzhuf-slice
              api.compress_many on the headline batch at lh5, one 16 MiB
              buffer of it at lh7 and 1 MiB at lh4 and lh6, device "cuda":
              every body equals the oracle's lzhuf encode (max_chain 16);
              then api.decompress_many of each gives the input back. Each
              call runs with the launch counts set to 0 just before it and
              read just after: the v1 parse walk on encode, the token walk
              and the copy machine on decode; nothing declines to the host
 11. lzhuf-timing
              lh5 encode MB/s (warm median of 3 calls on the timing
              batches) and decode MB/s (warm median of 3 calls on the
              slice's lh5 blobs), each with a per-stage split from CUDA
              events
 12. lzhuf-profile
              one more warm lh5 encode of the headline batch and decode of
              its blobs under torch.profiler: host wall time, device busy
              time (the union of the kernel, memcpy and memset intervals
              inside the call), the device's idle share (1 - busy / wall)
              and the device ops that took the most time
 13. bzip2-kernels
              the bzip2 symbol-walk kernel against its plain torch version
              (exact records and meta) on small stdlib and oracle streams
              at levels 1 and 9 and on a corrupted one; the iBWT kernels
              against their plain version (exact bytes and flags) on those
              blocks, a periodic block and the headline batch's last
              columns (the 2 x 16 MiB corpus.mixed batch, oracle bzip2
              level 9), all at the decode's splitter stride; both kernels
              timed at the headline shape
 14. bzip2-slice
              api.decompress_many on the headline blobs, api.decompress on
              a 16 MiB stdlib bz2 level 9 stream and on a two-stream
              concatenation, device "cuda": every output equals its input,
              each path (counts set to 0 just before it) one dispatch that
              launched each kernel once, nothing sent to decompress's
              second route (host symbol decode) or the host decoder
 15. bzip2-timing
              warm median of 3 decompress_many calls on the headline blobs
              (MB/s of plaintext), a per-stage split from CUDA events, and
              one call under torch.profiler (device busy time and idle
              share, as phase 12)
 16. bzip2-encode-kernels
              the MTF-encode kernel against its plain version (exact
              ranks) on the symbols and the selectors (alpha 6) of small
              buffers and of the headline batch at level 9, built by the
              encode's own stages; the headline's calls timed
 17. bzip2-encode-slice
              api.compress_many on the headline batch at level 9, device
              "cuda": the streams equal the oracle's blobs of phase 13, bz2
              and the port's decode give the inputs back, one dispatch
              (counts set to 0 just before it) launched the MTF kernel
              twice (symbols, selectors); api.compress of 1 MiB at level
              1, b"", b"a" and bytes(range(256)) * 40 the same; the 1 MiB
              buffer again in dispatches of at most 4 blocks
 18. bzip2-encode-timing
              warm median of 3 compress_many calls on the timing batches
              (MB/s), a per-stage split from CUDA events, and one call
              under torch.profiler
 19. parse-kernels-8-9
              the v3w walk kernel against its plain version on 1 MiB of
              corpus.mixed and corpus.repetitive at levels 1 and 6
              (greedy, lazy) and at the headline, and against #1 at
              n_extend=1 at live positions; greedy_parse on the headline
              gzip parse's lengths gives back its token set, the reach
              kernel equals the pointer doubling there; each called
              through its public function with its count set to 0, both
              timed at the headline
A JSON record of the kernels (launches from each one's main-path call:
gzip encode, gzip decode, lh5 encode, lh5 decode, bzip2 decode, the
public functions of #8 and #9, bzip2 encode; times and bounds at the
headline shapes) comes before the card's name and power limit; the last
line is {"ok": true, "device": {...}}. Needs the repository checkout
around it.
"""

from __future__ import annotations

import bz2
import gzip
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

MIB = 1 << 20
HEADLINE_BYTES = 16 * MIB
HEADLINE_BUFFERS = 2
LEVEL = 6
TIMING_ITERS = 3
LZHUF_METHOD = "lh5"
# A kernel's bound is the larger of its bytes (each input read once, each
# array the kernel writes written once) over the card's memory rate and
# its int32 operations over the card's int32 rate. NVIDIA's H100 SXM
# datasheet (700 W): 3.35 TB/s, and 67 T/s float32 outside the tensor
# cores, i.e. 132 SMs x 128 FP32 lanes x 2 (an FMA) x 1.98 GHz. An SM has
# 64 INT32 lanes (NVIDIA's Hopper architecture whitepaper), so int32
# issues at 67e12 / 2 / 2 per second.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 4
# Operations per loop trip, counted by hand from the CUDA sources (each
# add, shift, logical op, compare, select, min, max, load and store is
# one) along the trip's shortest path: a level-2 escape, a lazy probe or
# a corrupt-input clamp adds more, so the bound stays a least time.
OPS_STAGE_WORD = 4         # Huffman walks: staging one table/slice word
OPS_LZHUF_LITERAL = 44     # lzhuf_walk.cu: a token that is a literal
OPS_LZHUF_MATCH = 108      # ... a match (p lookup, raw bits, marker)
OPS_SYMBOL_LITERAL = 49    # symbol_walk.cu: a literal
OPS_SYMBOL_MATCH = 137     # ... a match (length and distance extras)
OPS_V1_VISIT = 31          # parse_v1_walk.cu: a visited position
OPS_V1_EXTEND = 16         # ... one 4-byte extension compare
OPS_V3_TOKEN = 15          # parse_walk.cu: a token on the mark fast path
OPS_COPY_POSITION = 16     # resolve_walk.cu: window state + phase 2 check
OPS_COPY_MATCHED = 12      # ... phase 1's copy of one matched position
OPS_BZIP2_TRIP = 60        # bzip2_walk.cu: one trip (a symbol, or a held one)
OPS_BZIP2_MTF = 24         # ... a move-to-front and its record
OPS_IBWT_STEP = 17         # ibwt_walk.cu: a node in pass 1 and in pass 2
OPS_IBWT_CHAIN = 45        # ... a chain's set-up in both passes and stitch
OPS_MTF_SYMBOL = 40        # mtf_encode.cu: a symbol's rank and move
OPS_REACH_STEP = 8         # reach_walk.cu: a visited position
OPS_V3W_TOKEN = 36         # parse_v3w_walk.cu: a token through TOK and FIN
OPS_V3W_EXTEND = 12        # ... one 4-byte extension compare
BZIP2_LEVEL = 9


def _mixed(args):
    from tpz_torch.utils import corpus

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


def drive(phase, path, fn, counters):
    """Run fn() with each counter (a wrapper with .launches) set to 0 just
    before it and read just after; raises if one stayed 0. Returns (fn's
    result, seconds, counts)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {name: c.launches for name, c in counters.items()}
    if min(counts.values()) < 1:
        raise RuntimeError(f"{phase} {path}: a kernel of the path was never "
                           f"launched: {counts}")
    return out, dt, counts


def stage_split(run) -> dict:
    """Milliseconds between CUDA events recorded at each stage hook of
    run(hook), summed by stage name."""
    events = [("start", torch.cuda.Event(enable_timing=True))]
    events[0][1].record()

    def hook(stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((stage, ev))

    run(hook)
    torch.cuda.synchronize()
    split = {}
    for (_, prev), (name, ev) in zip(events, events[1:]):
        split[name] = split.get(name, 0.0) + prev.elapsed_time(ev)
    return split


def warm_median(fn, iters):
    times = []
    for args in iters:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def walk_ops(markers, staged, literal, match) -> int:
    """A Huffman walk's operations: the staging copy of `staged` words and
    one trip per literal and per match marker."""
    kind = markers >> 28
    return (staged * OPS_STAGE_WORD + int((kind == 1).sum()) * literal
            + int((kind == 2).sum()) * match)


def bound(tensors, ops) -> dict:
    """bound_ms and bound_by for a kernel call that reads or writes each
    of `tensors` once and does `ops` operations."""
    return bound_bytes_ops(sum(t.numel() * t.element_size()
                               for t in tensors), ops)


def bound_bytes_ops(nbytes, ops) -> dict:
    """bound_ms and bound_by for a kernel call that moves `nbytes` and
    does `ops` operations."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


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
    return err, ms, plain_ms, got


def phase_kernel(headline, small):
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import parse

    for name, data in small.items():
        for level in (1, 6):
            cfg = DeflateConfig(level=level)
            err, *_ = compare_parse(parse_inputs([data], cfg, "cuda"), cfg)
            log("kernel", input=name, level=level, blocks=16, max_abs_err=err)
    cfg = DeflateConfig(level=LEVEL)
    inputs = parse_inputs(headline, cfg, "cuda")
    err, cold_ms, plain_ms, got = compare_parse(inputs, cfg)
    args = _parse_args(cfg)
    _, ms = timed(lambda: parse.parse_extend_v3(*inputs, *args), 5)
    log("kernel", input="headline", blocks=inputs[0].shape[0],
        restart=cfg.restart, max_abs_err=err, ms=f"{ms:.3f}",
        first_call_ms=f"{cold_ms:.3f}", plain_ms=f"{plain_ms:.3f}")
    # The kernel writes one [NB, N] int32 array; visited is its size.
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound([*inputs, got[0]],
                    int((got[0] > 0).sum()) * OPS_V3_TOKEN)}


def phase_slice(batch):
    from tpz_torch import api, oracle
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import parse

    blobs, dt, c = drive("slice", "gzip-encode", lambda: api.compress_many(
        batch, "gzip", level=LEVEL, device="cuda"),
        {"parse": parse.parse_extend_v3})
    launches = c["parse"]
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
    median, times = warm_median(lambda b: api.compress_many(
        b, "gzip", level=LEVEL, device="cuda"), batches)
    log("timing", mb_per_s=f"{total / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        card=f"'{smi}'")

    # Per-stage split: a CUDA event after each device stage.
    batch = batches[-1]
    bodies = []
    split = stage_split(lambda hook: bodies.extend(dp.compress_many(
        batch, DeflateConfig(LEVEL), "cuda", stage_hook=hook)))
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
    walk_bound = bound([*args, markers], walk_ops(
        markers, args[0].numel() + args[3].numel(), OPS_SYMBOL_LITERAL,
        OPS_SYMBOL_MATCH))
    res_bound = bound(prep[:2], copy_ops(prep[0]))
    return ({"max_abs_err": err_w, "ms": walk_ms, "plain_ms": walk_plain_ms,
             **walk_bound},
            {"max_abs_err": err_r, "ms": res_ms, "plain_ms": res_plain_ms,
             **res_bound})


def copy_ops(markers) -> int:
    """The copy machine's operations on `markers`: every position once in
    each phase, and phase 1's copy of each position inside a match."""
    return (markers.numel() * OPS_COPY_POSITION
            + int((markers == 0).sum()) * OPS_COPY_MATCHED)


def drive_decode(path, fn, want):
    """One decode path with both kernels' counts set to 0 just before it
    and read just after; raises unless it returns `want`, launched both
    kernels and declined nothing to the host. Returns its counts."""
    from tpz_torch.kernels import inflate_pipeline as ip
    from tpz_torch.kernels import resolve_walk as rw

    declines = ip.host_declines
    out, dt, launches = drive("decode-slice", path, fn, {
        "walk": ip.symbol_walk, "resolve": rw.resolve_copy_machine})
    if out != want:
        raise RuntimeError(f"{path}: decode did not return its input")
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
    median, times = warm_median(lambda _: api.decompress_many(
        blobs, "gzip", device="cuda"), range(TIMING_ITERS))
    log("decode-timing", mb_per_s=f"{total / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        card=f"'{smi}'")

    # Per-stage split: a CUDA event after each stage, summed over buffers.
    split = stage_split(lambda hook: gzip_codec.decompress_many(
        blobs, device="cuda", stage_hook=hook))
    t0 = time.perf_counter()
    for d in batch:
        zlib.crc32(d)
    split["host_crc"] = (time.perf_counter() - t0) * 1e3
    log("decode-timing", **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})


def _dict_bits(method: str) -> int:
    from tpz_torch import constants as C

    return C.LZHUF_METHODS[method][0]


def lzhuf_parse_inputs(datas, method):
    """The v1 parse walk's inputs (screen, best_j, words, block_len) for
    `datas`, built on the card by the LZHUF encode pipeline's own
    stages, and the window."""
    from tpz_torch.kernels import lzhuf_pipeline as lp
    from tpz_torch.kernels import matchfinder as mf

    window = 1 << _dict_bits(method)
    blocks, span_off, span_len, block_len, _ = lp.make_blocks(
        datas, window, "cuda")
    so, sln, bl = (torch.from_numpy(a).cuda()
                   for a in (span_off, span_len, block_len))
    bj, bs, words, _ = mf.screen_candidates(blocks, so, sln, lp.MAX_CHAIN,
                                            window, lp.BLOCK, lp.MAX_MATCH)
    sl = slice(window, window + lp.BLOCK)
    return (bs[:, sl].contiguous(), bj[:, sl].contiguous(), words, bl), window


def compare_parse_v1(inputs, window):
    """v1 parse-walk kernel vs plain on the same CUDA tensors: ((reach,
    mlen), max abs difference, kernel ms, plain ms), each timed on its
    first call. Raises unless both outputs are equal everywhere."""
    from tpz_torch.kernels import lzhuf_pipeline as lp
    from tpz_torch.kernels import parse

    before = parse.parse_extend_v1.launches
    got, ms = timed(lambda: parse.parse_extend_v1(
        *inputs, window, max_match=lp.MAX_MATCH))
    if parse.parse_extend_v1.launches != before + 1:
        raise RuntimeError("v1 parse wrapper did not launch its kernel")
    want, plain_ms = timed(lambda: parse.parse_extend_v1_plain(
        *inputs, window, max_match=lp.MAX_MATCH))
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if err:
        raise RuntimeError(f"v1 parse kernel disagrees with plain: {err}")
    return got, err, ms, plain_ms


def lzhuf_walk_inputs(body, n, method):
    """The device layout of the raw LZHUF body `body` (n output bytes):
    segments cut at 64 KiB and at every block's table change, as the
    decode pipeline's own host stages build it."""
    from tpz_torch import oracle
    from tpz_torch.kernels import inflate_pipeline as ip
    from tpz_torch.kernels import lzhuf_walk as lw

    bits = _dict_bits(method)
    idx = oracle.lzhuf_index(body, n, bits, seg_out=lw.BLOCK)
    spans = (idx["end_bits"] + 7) // 8 + 1 - idx["seg_bits"] // 8
    rows = lw._segment_tables(idx, oracle._lzhuf_np(bits))
    if rows is None or int(spans.max()) > lw.SLICE_BYTES:
        raise RuntimeError(f"{method}: the stream does not fit the walk")
    return ip._to_device(lw._layout([(body, idx, spans, rows)]), "cuda")


def compare_lzhuf_walk(t):
    """LZHUF token-walk kernel vs plain on the same CUDA tensors:
    (markers, max abs difference, kernel ms, plain ms), each timed on its
    first call. Raises unless the markers are equal."""
    from tpz_torch.kernels import lzhuf_walk as lw

    args = lw._walk_args(t)
    before = lw.lzhuf_walk.launches
    got, ms = timed(lambda: lw.lzhuf_walk(*args))
    if lw.lzhuf_walk.launches != before + 1:
        raise RuntimeError("lzhuf walk wrapper did not launch its kernel")
    want, plain_ms = timed(lambda: lw.lzhuf_walk_plain(*args))
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise RuntimeError(f"lzhuf-walk kernel disagrees with plain: {err}")
    return got, err, ms, plain_ms


def phase_lzhuf_kernels(small, headline):
    """Both LZHUF kernels and the copy machine at dist_bias 1 on the
    LZHUF path's inputs; returns the headline rows of #4 and #5."""
    from tpz_torch import oracle
    from tpz_torch.kernels import lzhuf_pipeline as lp
    from tpz_torch.kernels import lzhuf_walk as lw
    from tpz_torch.kernels import parse

    err_p = err_w = err_r = 0
    for method in ("lh5", "lh7"):
        inputs, window = lzhuf_parse_inputs([small], method)
        _, e, _, _ = compare_parse_v1(inputs, window)
        err_p = max(err_p, e)
        t = lzhuf_walk_inputs(oracle.lzhuf_encode(small, _dict_bits(method),
                                                  lp.MAX_CHAIN),
                              len(small), method)
        markers, e, _, _ = compare_lzhuf_walk(t)
        err_w = max(err_w, e)
        err_r = max(err_r, compare_resolve(lw._dense_markers(markers, t), 1))
        log("lzhuf-kernels", input=f"1MiB-mixed-{method}",
            blocks=inputs[0].shape[0], segments=t["out_len"].shape[0],
            parse_max_abs_err=err_p, walk_max_abs_err=err_w,
            resolve_max_abs_err=err_r)

    inputs, window = lzhuf_parse_inputs(headline, LZHUF_METHOD)
    got, e, cold_ms, _ = compare_parse_v1(inputs, window)
    err_p = max(err_p, e)
    _, parse_ms = timed(lambda: parse.parse_extend_v1(
        *inputs, window, max_match=lp.MAX_MATCH), 5)
    _, parse_plain_ms = timed(lambda: parse.parse_extend_v1_plain(
        *inputs, window, max_match=lp.MAX_MATCH), 3)
    # The kernel writes reach; mlen is derived from it afterwards. A match
    # extends from a screen of at most 8 bytes, 4 bytes a compare.
    parse_bound = bound([*inputs, got[0]], int((got[0] > 0).sum())
                        * OPS_V1_VISIT + int((torch.clamp(got[1] - 8, min=0)
                                              // 4).sum()) * OPS_V1_EXTEND)
    log("lzhuf-kernels", input=f"headline-{LZHUF_METHOD}",
        blocks=inputs[0].shape[0], parse_max_abs_err=err_p,
        parse_ms=f"{parse_ms:.3f}", parse_first_call_ms=f"{cold_ms:.3f}",
        parse_plain_ms=f"{parse_plain_ms:.3f}",
        parse_bound_ms=f"{parse_bound['bound_ms']:.4f}")
    del inputs, got

    data = headline[0]
    t = lzhuf_walk_inputs(oracle.lzhuf_encode(data, _dict_bits(LZHUF_METHOD),
                                              lp.MAX_CHAIN),
                          len(data), LZHUF_METHOD)
    markers, e, cold_ms, walk_plain_ms = compare_lzhuf_walk(t)
    err_w = max(err_w, e)
    args = lw._walk_args(t)
    _, walk_ms = timed(lambda: lw.lzhuf_walk(*args), 5)
    err_r = max(err_r, compare_resolve(lw._dense_markers(markers, t), 1))
    walk_bound = bound([*args, markers], walk_ops(
        markers, args[0].numel() + args[4].numel(), OPS_LZHUF_LITERAL,
        OPS_LZHUF_MATCH))
    log("lzhuf-kernels", input=f"16MiB-{LZHUF_METHOD}",
        segments=args[0].shape[0], walk_max_abs_err=err_w,
        resolve_max_abs_err=err_r, walk_ms=f"{walk_ms:.3f}",
        walk_first_call_ms=f"{cold_ms:.3f}",
        walk_plain_ms=f"{walk_plain_ms:.3f}",
        walk_bound_ms=f"{walk_bound['bound_ms']:.4f}")
    return ({"max_abs_err": err_p, "ms": parse_ms,
             "plain_ms": parse_plain_ms, **parse_bound},
            {"max_abs_err": err_w, "ms": walk_ms, "plain_ms": walk_plain_ms,
             **walk_bound})


def phase_lzhuf_slice(batch, small):
    """LZHUF encode and decode through the api on the card, against the
    oracle's bytes and the inputs. Returns the lh5 batch's blobs and its
    encode and decode counts."""
    from tpz_torch import api, oracle
    from tpz_torch.kernels import lzhuf_walk as lw
    from tpz_torch.kernels import parse
    from tpz_torch.kernels import resolve_walk as rw

    cases = {LZHUF_METHOD: list(batch), "lh7": [batch[0]], "lh4": [small],
             "lh6": [small]}
    blobs, counts = {}, {}
    for method, datas in cases.items():
        out, dt, c = drive("lzhuf-slice", f"encode-{method}",
                           lambda: api.compress_many(datas, method,
                                                     device="cuda"),
                           {"parse_v1": parse.parse_extend_v1})
        bits = _dict_bits(method)
        for i, (d, blob) in enumerate(zip(datas, out)):
            if blob[15:] != oracle.lzhuf_encode(d, bits, 16):
                raise RuntimeError(f"{method} buffer {i}: body differs from "
                                   "the oracle's")
        blobs[method] = out
        counts[method] = c
        log("lzhuf-slice", path=f"encode-{method}", buffers=len(datas),
            bytes=sum(len(d) for d in datas),
            ratio=f"{sum(map(len, out)) / sum(map(len, datas)):.4f}",
            cold_s=f"{dt:.3f}", parse_v1_launches=c["parse_v1"],
            oracle_identical=True)
    for method, datas in cases.items():
        declines = lw.host_declines
        got, dt, c = drive("lzhuf-slice", f"decode-{method}",
                           lambda: api.decompress_many(blobs[method], method,
                                                       device="cuda"),
                           {"walk": lw.lzhuf_walk,
                            "resolve": rw.resolve_copy_machine})
        if got != datas:
            raise RuntimeError(f"decode-{method}: did not return its input")
        if lw.host_declines != declines:
            raise RuntimeError(f"decode-{method}: declined to the host")
        counts[method].update(c)
        log("lzhuf-slice", path=f"decode-{method}", cold_s=f"{dt:.3f}",
            walk_launches=c["walk"], resolve_launches=c["resolve"],
            host_declines=0, identical=True)
    return blobs[LZHUF_METHOD], counts[LZHUF_METHOD]


def phase_lzhuf_timing(batches, batch, blobs, smi) -> None:
    from tpz_torch import api
    from tpz_torch.codecs import lzhuf
    from tpz_torch.kernels import lzhuf_pipeline as lp

    total = sum(len(d) for d in batches[0])
    median, times = warm_median(lambda b: api.compress_many(
        b, LZHUF_METHOD, device="cuda"), batches)
    log("lzhuf-timing", direction="encode", method=LZHUF_METHOD,
        mb_per_s=f"{total / median / 1e6:.2f}", median_s=f"{median:.4f}",
        all_s=[round(t, 4) for t in times], card=f"'{smi}'")
    split = stage_split(lambda hook: lp.compress_many(
        batches[-1], LZHUF_METHOD, "cuda", stage_hook=hook))
    log("lzhuf-timing", direction="encode",
        **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})

    total = sum(len(d) for d in batch)
    median, times = warm_median(lambda _: api.decompress_many(
        blobs, LZHUF_METHOD, device="cuda"), range(TIMING_ITERS))
    log("lzhuf-timing", direction="decode", method=LZHUF_METHOD,
        mb_per_s=f"{total / median / 1e6:.2f}", median_s=f"{median:.4f}",
        all_s=[round(t, 4) for t in times], card=f"'{smi}'")
    split = stage_split(lambda hook: lzhuf.decompress_many(
        blobs, LZHUF_METHOD, device="cuda", stage_hook=hook))
    log("lzhuf-timing", direction="decode",
        **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(events, t0_us: float, t1_us: float):
    """(busy ms, {op name: ms}) of the device events of a chrome trace
    that lie in [t0_us, t1_us]."""
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, d = float(e["ts"]), float(e.get("dur", 0))
        if a < t0_us or a + d > t1_us:
            continue
        spans.append((a, a + d))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d / 1e3
    busy, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy / 1e3, by_name


def profile_call(fn, label: str, phase: str = "lzhuf-profile") -> None:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(label):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    mark = next(e for e in events if e.get("name") == label
                and e.get("cat") == "user_annotation")
    t0_us = float(mark["ts"])
    busy_ms, by_name = device_busy(events, t0_us, t0_us + float(mark["dur"]))
    if busy_ms <= 0:
        raise RuntimeError(f"{label}: the trace holds no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(phase, call=label, wall_ms=f"{wall_ms:.2f}",
        busy_ms=f"{busy_ms:.2f}", idle_share=f"{1 - busy_ms / wall_ms:.4f}",
        top=json.dumps({k[:60]: round(v, 3) for k, v in top}))


def phase_lzhuf_profile(batch, blobs) -> None:
    from tpz_torch import api

    profile_call(lambda: api.compress_many(batch, LZHUF_METHOD,
                                           device="cuda"),
                 f"{LZHUF_METHOD}-encode")
    profile_call(lambda: api.decompress_many(blobs, LZHUF_METHOD,
                                             device="cuda"),
                 f"{LZHUF_METHOD}-decode")


def bzip2_layout(blobs):
    """The walk's device layout of the blocks of `blobs`, as the bzip2
    decode pipeline's host stages build it for one level bucket: (tensors
    on the card, N, S)."""
    from tpz_torch import oracle
    from tpz_torch.kernels import bzip2_pipeline as bp
    from tpz_torch.kernels import bzip2_walk as bw

    level = max(bp._max_level(b) for b in blobs)
    N = bp._bucket(bw.rec_cap_for(level))
    scan, slices = bp.group_inputs(
        blobs, [oracle.bzip2_scan_headers(b) for b in blobs], N)
    t = {k: torch.from_numpy(v).cuda()
         for k, v in bw.block_layout(scan, slices).items()}
    return t, N, bw.records_cap(N, bw.rec_cap_for(level))


def compare_bzip2_walk(t, S):
    """bzip2 symbol-walk kernel vs plain on the same CUDA tensors: (recs,
    meta, max abs difference, kernel ms, plain ms), each timed on its
    first call. Raises unless records and meta are equal."""
    from tpz_torch.kernels import bzip2_walk as bw

    args = [t[k] for k in bw.WALK_ARGS]
    before = bw.bzip2_walk.launches
    (recs, meta), ms = timed(lambda: bw.bzip2_walk(*args, S))
    if bw.bzip2_walk.launches != before + 1:
        raise RuntimeError("bzip2 walk wrapper did not launch its kernel")
    (precs, pmeta), plain_ms = timed(lambda: bw.bzip2_walk_plain(*args, S))
    err = max(int((recs.long() - precs.long()).abs().max()),
              int((meta.long() - pmeta.long()).abs().max()))
    if err:
        raise RuntimeError(f"bzip2-walk kernel disagrees with plain: {err}")
    return recs, meta, err, ms, plain_ms


def ibwt_inputs(t, recs, meta, N):
    """The iBWT walk's (w, start_g, length) from the symbol walk's output,
    through the decode's own expansion and LF sort."""
    from tpz_torch.kernels import bzip2_walk as bw
    from tpz_torch.kernels import ibwt_walk as iw

    last, lens, _, orig = bw.expand_records(recs, meta, t["origs"], N)
    return iw.lf_inputs(last, lens, orig)[:3]


def compare_ibwt(args, seg):
    """iBWT kernels vs plain on the same CUDA tensors: (out, flag, max abs
    difference, kernel ms, plain ms), each timed on its first call.
    Raises unless bytes and flags are equal."""
    from tpz_torch.kernels import ibwt_walk as iw

    before = iw.ibwt.launches
    (out, flag), ms = timed(lambda: iw.ibwt(*args, seg))
    if iw.ibwt.launches != before + 1:
        raise RuntimeError("ibwt wrapper did not launch its kernels")
    (pout, pflag), plain_ms = timed(lambda: iw.ibwt_walk_plain(*args, seg))
    err = max(int((out.int() - pout.int()).abs().max()),
              int((flag - pflag).abs().max()))
    if err:
        raise RuntimeError(f"ibwt kernels disagree with plain: {err}")
    return out, flag, err, ms, plain_ms


def bzip2_walk_ops(recs, meta) -> int:
    """The symbol walk's operations on its records: a trip per record,
    per run symbol of a run record (count >= 2: floor(log2(count + 1))
    symbols) and per block's end, and a move-to-front per count-1 record
    (a count-1 run record counts as a literal, so the bound stays a least
    time)."""
    live = torch.arange(recs.shape[1], device=recs.device)[None, :] \
        < meta[:, :1]
    cnt = torch.where(live, recs.long() >> 8, 0)
    runs = torch.where(cnt >= 2, torch.floor(torch.log2(
        (cnt + 1).double())).long(), 0)
    trips = int(meta[:, 0].sum()) + int(runs.sum()) + recs.shape[0]
    return trips * OPS_BZIP2_TRIP + int((cnt == 1).sum()) * OPS_BZIP2_MTF


def phase_bzip2_kernels(small, blobs):
    """#6 and #7 against their plain versions on the small streams, a
    periodic block and (the iBWT) the headline batch; both timed at the
    headline shape. Returns their kernel-line rows."""
    from tpz_torch import oracle
    from tpz_torch.kernels import bzip2_walk as bw
    from tpz_torch.kernels import ibwt_walk as iw

    err_w = err_i = 0
    walk_plain_ms = walk_plain_at = None
    for name, blob in small.items():
        t, N, S = bzip2_layout([blob])
        recs, meta, e, _, plain_ms = compare_bzip2_walk(t, S)
        err_w = max(err_w, e)
        if walk_plain_ms is None or plain_ms > walk_plain_ms:
            walk_plain_ms, walk_plain_at = plain_ms, name
        kv = {}
        if int(meta[:, 1].abs().sum()) == 0:
            args = ibwt_inputs(t, recs, meta, N)
            _, flag, e, _, _ = compare_ibwt(args, iw.IBWT_SEG)
            err_i = max(err_i, e)
            kv = {"ibwt_max_abs_err": err_i, "flags": flag.tolist()}
        log("bzip2-kernels", input=name, blocks=t["sw"].shape[0],
            records=meta[:, 0].tolist(), err=meta[:, 1].tolist(),
            walk_max_abs_err=err_w, plain_ms=f"{plain_ms:.1f}", **kv)
    # A periodic block: the LF map splits into cycles, both flag it.
    t, N, S = bzip2_layout([oracle.bzip2_encode(b"abc" * 4000, 1)])
    recs, meta, _, _, _ = compare_bzip2_walk(t, S)
    _, flag, e, _, _ = compare_ibwt(ibwt_inputs(t, recs, meta, N),
                                    iw.IBWT_SEG)
    if flag.tolist() != [1]:
        raise RuntimeError(f"periodic block not flagged: {flag.tolist()}")
    log("bzip2-kernels", input="periodic-abc", ibwt_max_abs_err=e,
        flags=flag.tolist())

    t, N, S = bzip2_layout(blobs)
    args = [t[k] for k in bw.WALK_ARGS]
    (recs, meta), cold_ms = timed(lambda: bw.bzip2_walk(*args, S))
    _, walk_ms = timed(lambda: bw.bzip2_walk(*args, S), 5)
    if int(meta[:, 1].abs().sum()):
        raise RuntimeError(f"headline walk errors: {meta[:, 1].tolist()}")
    nrec = meta[:, 0].long()
    slice_bytes = int(((meta[:, 2].long() + 7) // 8).sum())
    walk_bytes = (slice_bytes + int(nrec.sum()) * 4
                  + sum(args[k].numel() * args[k].element_size()
                        for k in (0, 1, 2, 4, 5, 6)) + meta.numel() * 4)
    walk_bound = bound_bytes_ops(walk_bytes, bzip2_walk_ops(recs, meta))
    log("bzip2-kernels", input="headline-2x16MiB-l9", blocks=len(nrec),
        N=N, S=S, records=int(nrec.sum()), records_max=int(nrec.max()),
        walk_ms=f"{walk_ms:.3f}",
        walk_first_call_ms=f"{cold_ms:.3f}",
        walk_plain_ms=f"{walk_plain_ms:.3f}",
        walk_plain_shape=walk_plain_at,
        walk_bound_ms=f"{walk_bound['bound_ms']:.4f}")

    args = ibwt_inputs(t, recs, meta, N)
    del recs, t
    seg = iw.IBWT_SEG
    _, flag, e, cold_ms, ibwt_plain_ms = compare_ibwt(args, seg)
    err_i = max(err_i, e)
    if int(flag.sum()):
        raise RuntimeError(f"headline blocks flagged: {flag.tolist()}")
    _, ibwt_ms = timed(lambda: iw.ibwt(*args, seg), 5)
    n = int(args[2].long().sum())
    chains = int(flag.numel()) * iw.chains_per_block(N, seg)
    ibwt_bound = bound_bytes_ops(
        n * 5 + chains * 12 + 8 * flag.numel(),
        n * OPS_IBWT_STEP + chains * OPS_IBWT_CHAIN)
    log("bzip2-kernels", input="headline-2x16MiB-l9", nodes=n,
        seg=seg, ibwt_max_abs_err=err_i,
        ibwt_first_call_ms=f"{cold_ms:.3f}",
        ibwt_plain_ms=f"{ibwt_plain_ms:.3f}", ibwt_ms=f"{ibwt_ms:.3f}",
        ibwt_bound_ms=f"{ibwt_bound['bound_ms']:.4f}")
    return ({"max_abs_err": err_w, "ms": walk_ms, "plain_ms": walk_plain_ms,
             **walk_bound},
            {"max_abs_err": err_i, "ms": ibwt_ms,
             "plain_ms": ibwt_plain_ms, **ibwt_bound})


def drive_bzip2(path, fn, want):
    """One bzip2 decode path with both kernels' counts set to 0 just
    before it and read just after; raises unless it returns `want` from
    one dispatch (each kernel launched once: a walk whose result was
    refused would send the stream on to a second iBWT, or to the host)
    with nothing sent to decompress's second route or the host decoder.
    Returns its counts."""
    from tpz_torch.kernels import bzip2_pipeline as bp
    from tpz_torch.kernels import bzip2_walk as bw
    from tpz_torch.kernels import ibwt_walk as iw

    host = bp.host_declines, bp.host_symbol_decodes
    out, dt, launches = drive("bzip2-slice", path, fn, {
        "walk": bw.bzip2_walk, "ibwt": iw.ibwt})
    if out != want:
        raise RuntimeError(f"{path}: decode did not return its input")
    if (bp.host_declines, bp.host_symbol_decodes) != host:
        raise RuntimeError(f"{path}: decode left the device walk (host "
                           f"declines, second route: {host} -> "
                           f"{(bp.host_declines, bp.host_symbol_decodes)})")
    if launches != {"walk": 1, "ibwt": 1}:
        raise RuntimeError(f"{path}: not one launch of each kernel: "
                           f"{launches}")
    log("bzip2-slice", path=path, cold_s=f"{dt:.3f}",
        walk_launches=launches["walk"], ibwt_launches=launches["ibwt"],
        host_declines=0, host_symbol_decodes=0, identical=True)
    return launches


def phase_bzip2_slice(batch, blobs, stdlib_blob, cat, cat_want):
    """The bzip2 decode main path and two other entry paths, each with
    launch counts of its own; returns the headline batch's counts."""
    from tpz_torch import api

    launches = drive_bzip2(
        "batch-2x16MiB-oracle-l9",
        lambda: api.decompress_many(blobs, "bzip2", device="cuda"), batch)
    drive_bzip2("stdlib-bz2-l9-16MiB",
                lambda: api.decompress(stdlib_blob, "bzip2", device="cuda"),
                batch[1])
    drive_bzip2("two-stream-concat",
                lambda: api.decompress(cat, "bzip2", device="cuda"), cat_want)
    return launches


def phase_bzip2_timing(batch, blobs, smi) -> None:
    from tpz_torch import api
    from tpz_torch.codecs import bzip2

    total = sum(len(d) for d in batch)
    median, times = warm_median(lambda _: api.decompress_many(
        blobs, "bzip2", device="cuda"), range(TIMING_ITERS))
    log("bzip2-timing", mb_per_s=f"{total / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        card=f"'{smi}'")
    split = stage_split(lambda hook: bzip2.decompress_many(
        blobs, device="cuda", stage_hook=hook))
    log("bzip2-timing", **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})
    profile_call(lambda: api.decompress_many(blobs, "bzip2", device="cuda"),
                 "bzip2-decode", phase="bzip2-timing")


def bzip2_inputs(batch):
    """The bzip2 phases' streams: the headline batch at oracle level 9, a
    16 MiB stdlib level-9 stream, a two-stream concatenation (stdlib level
    1 then oracle level 9) and the small streams of phase 13 (about 5,000
    symbols a block: the plain walk takes one trip per symbol, about 2 ms
    each on the card), one with zeroed symbol bits."""
    from concurrent.futures import ThreadPoolExecutor

    from tpz_torch import oracle
    from tpz_torch.utils import corpus

    with ThreadPoolExecutor(len(batch) + 1) as pool:
        stdlib = pool.submit(bz2.compress, batch[1], BZIP2_LEVEL)
        blobs = list(pool.map(lambda d: oracle.bzip2_encode(d, BZIP2_LEVEL),
                              batch))
        stdlib = stdlib.result()
    a, b = corpus.text(MIB, seed=31), corpus.mixed(MIB, seed=32)
    cat = (bz2.compress(a, 1) + oracle.bzip2_encode(b, BZIP2_LEVEL), a + b)
    # Zeroed symbol bits decode as a run that outgrows 2^21 (err 8).
    corrupt = bytearray(bz2.compress(corpus.text(8192, seed=25), 1))
    corrupt[1000:1100] = bytes(100)
    small = {
        "stdlib-l1-text-8KiB": bz2.compress(corpus.text(8192, seed=21), 1),
        "stdlib-l9-mixed-8KiB": bz2.compress(corpus.mixed(8192, seed=22), 9),
        "oracle-l1-two-streams": oracle.bzip2_encode(
            corpus.text(5000, seed=23), 1) + oracle.bzip2_encode(
            corpus.mixed(5000, seed=26), 1),
        "oracle-l9-text-8KiB": oracle.bzip2_encode(
            corpus.text(8192, seed=24), 9),
        "corrupt-stdlib-l1-text-8KiB": bytes(corrupt)}
    return blobs, stdlib, cat, small


def bzip2_encode_front(datas):
    """The MTF kernel's two inputs on the bzip2 encode path for `datas` at
    level 9, built by the encode's own stages on the card: ((symbols,
    lengths), (selectors, counts), the BWT's rounds)."""
    from tpz_torch import oracle
    from tpz_torch.kernels import bwt, mtf, rle
    from tpz_torch.kernels import bzip2_pipeline as bp
    from tpz_torch.kernels import bzip2_plan_device as pd

    rows, lens, crcs, _ = bp.block_rows(bp.stream_blocks(
        [oracle.bzip2_rle1(d, BZIP2_LEVEL) for d in datas]))
    n = torch.from_numpy(lens).cuda()
    w = bwt.cyclic_words_device(torch.from_numpy(rows).cuda(), n)
    last, orig = bwt.bwt_batched(w, n)
    rounds = bwt.bwt_batched.rounds
    del w
    v, used = bp.mtf_input(last, n)
    syms, sym_len = rle.rle2_encode(mtf.mtf_ranks(v, n), n)
    seen = []
    real = pd.mtf_ranks
    pd.mtf_ranks = lambda s, c, alpha=256: seen.append((s, c)) or real(
        s, c, alpha)
    try:
        pd.encode_blocks(syms, sym_len, used, used.sum(1, dtype=torch.int32),
                         orig.to(torch.int32), torch.from_numpy(crcs).cuda())
    finally:
        pd.mtf_ranks = real
    return (v, n), seen[0], rounds


def compare_mtf(v, n, alpha):
    """MTF kernel vs plain on the same CUDA tensors: (max abs difference,
    kernel ms, plain ms), each timed on its first call. Raises unless the
    ranks are equal."""
    from tpz_torch.kernels import mtf

    before = mtf.mtf_ranks.launches
    got, ms = timed(lambda: mtf.mtf_ranks(v, n, alpha))
    if mtf.mtf_ranks.launches != before + 1:
        raise RuntimeError("mtf wrapper did not launch its kernel")
    want, plain_ms = timed(lambda: mtf.mtf_ranks_plain(v, n, alpha))
    err = int((got - want).abs().max())
    if err:
        raise RuntimeError(f"mtf kernel disagrees with plain: {err}")
    return err, ms, plain_ms


def phase_bzip2_encode_kernels(batch):
    """The MTF kernel against its plain version on the symbols and the
    selectors of small buffers and of the headline batch; the headline's
    calls timed. Returns its kernel-line row (the symbols' call)."""
    from tpz_torch.kernels import mtf
    from tpz_torch.utils import corpus

    rng = np.random.default_rng(61)
    small = {"text-8KiB": corpus.text(8192, seed=61),
             "mixed-64KiB": corpus.mixed(1 << 16, seed=62),
             "range256x40": bytes(range(256)) * 40,
             "random-5000": bytes(rng.integers(0, 256, 5000,
                                               dtype=np.uint8))}
    err = 0
    for name, data in small.items():
        (v, n), (sel, nsel), _ = bzip2_encode_front([data])
        e1, _, _ = compare_mtf(v, n, 256)
        e2, _, _ = compare_mtf(sel, nsel, 6)
        err = max(err, e1, e2)
        log("bzip2-encode-kernels", input=name, symbols=int(n.sum()),
            selectors=int(nsel.sum()), max_abs_err=err)
    (v, n), (sel, nsel), rounds = bzip2_encode_front(batch)
    e, cold_ms, plain_ms = compare_mtf(v, n, 256)
    _, ms = timed(lambda: mtf.mtf_ranks(v, n), 5)
    es, sel_cold_ms, sel_plain_ms = compare_mtf(sel, nsel, 6)
    _, sel_ms = timed(lambda: mtf.mtf_ranks(sel, nsel, 6), 5)
    err = max(err, e, es)
    symbols = int(n.long().sum())
    # The walk reads each live symbol and writes its rank.
    mtf_bound = bound_bytes_ops(8 * symbols + 4 * n.numel(),
                                symbols * OPS_MTF_SYMBOL)
    log("bzip2-encode-kernels", input="headline-2x16MiB-l9",
        blocks=n.numel(), N=v.shape[1], bwt_rounds=rounds, symbols=symbols,
        max_abs_err=err, ms=f"{ms:.3f}", first_call_ms=f"{cold_ms:.3f}",
        plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{mtf_bound['bound_ms']:.4f}",
        selectors=int(nsel.long().sum()), sel_ms=f"{sel_ms:.3f}",
        sel_first_call_ms=f"{sel_cold_ms:.3f}",
        sel_plain_ms=f"{sel_plain_ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **mtf_bound}


def phase_bzip2_encode_slice(batch, blobs):
    """bzip2 encode through the api on the card: the headline batch at
    level 9 equals the oracle's blobs of phase 13 and round-trips through
    bz2 and the port's decode, one dispatch launching the MTF kernel for
    the symbols and the selectors; api.compress on 1 MiB at level 1, b"",
    b"a" and bytes(range(256)) * 40 the same, and the 1 MiB buffer again
    with its blocks spread over dispatches of at most 4. Returns the
    batch's MTF launches."""
    from tpz_torch import api, oracle
    from tpz_torch.kernels import bzip2_pipeline as bp
    from tpz_torch.kernels import mtf
    from tpz_torch.utils import corpus

    out, dt, c = drive("bzip2-encode-slice", "batch-2x16MiB-l9",
                       lambda: api.compress_many(batch, "bzip2", BZIP2_LEVEL,
                                                 device="cuda"),
                       {"mtf": mtf.mtf_ranks})
    if c["mtf"] != 2:
        raise RuntimeError(f"batch: not one dispatch (symbols and selectors):"
                           f" {c['mtf']} MTF launches")
    for i, (d, blob, ref) in enumerate(zip(batch, out, blobs)):
        if blob != ref:
            raise RuntimeError(f"buffer {i}: bzip2 stream differs from the "
                               "oracle's")
        if bz2.decompress(blob) != d:
            raise RuntimeError(f"buffer {i}: bz2 round trip failed")
    if api.decompress_many(out, "bzip2", device="cuda") != list(batch):
        raise RuntimeError("batch: the port's decode did not give it back")
    log("bzip2-encode-slice", path="batch-2x16MiB-l9", buffers=len(batch),
        bytes=sum(map(len, batch)),
        ratio=f"{sum(map(len, out)) / sum(map(len, batch)):.4f}",
        cold_s=f"{dt:.3f}", mtf_launches=c["mtf"], oracle_identical=True,
        bz2_round_trip=True, port_round_trip=True)
    cases = {"1MiB-mixed-l1": (corpus.mixed(MIB, seed=52), 1),
             "empty": (b"", BZIP2_LEVEL), "a": (b"a", BZIP2_LEVEL),
             "range256x40": (bytes(range(256)) * 40, BZIP2_LEVEL)}
    for name, (d, level) in cases.items():
        mtf.mtf_ranks.launches = 0
        blob = api.compress(d, "bzip2", level, device="cuda")
        if (blob != oracle.bzip2_encode(d, level) or bz2.decompress(blob) != d
                or api.decompress(blob, "bzip2", device="cuda") != d):
            raise RuntimeError(f"{name}: bzip2 encode differs or does not "
                               "round-trip")
        log("bzip2-encode-slice", path=f"compress-{name}", level=level,
            mtf_launches=mtf.mtf_ranks.launches, oracle_identical=True,
            round_trip=True)
    # One buffer whose blocks span dispatches: 1 MiB at level 1 in
    # dispatches of at most 4 blocks.
    d = cases["1MiB-mixed-l1"][0]
    n_disp = -(-oracle.bzip2_rle1(d, 1)[2].size // 4)
    keep, bp.MAX_DISPATCH_BLOCKS = bp.MAX_DISPATCH_BLOCKS, 4
    try:
        mtf.mtf_ranks.launches = 0
        blob = api.compress(d, "bzip2", 1, device="cuda")
    finally:
        bp.MAX_DISPATCH_BLOCKS = keep
    if (blob != oracle.bzip2_encode(d, 1) or n_disp < 2
            or mtf.mtf_ranks.launches != 2 * n_disp):
        raise RuntimeError("a buffer split across dispatches differs from the "
                           f"oracle's or ran {mtf.mtf_ranks.launches} MTF "
                           f"launches for {n_disp} dispatches")
    log("bzip2-encode-slice", path="compress-1MiB-mixed-l1-split",
        dispatches=n_disp, mtf_launches=mtf.mtf_ranks.launches,
        oracle_identical=True)
    return c["mtf"]


def phase_bzip2_encode_timing(batches, smi) -> None:
    from tpz_torch import api
    from tpz_torch.codecs import bzip2
    from tpz_torch.kernels import bwt

    total = sum(len(d) for d in batches[0])
    median, times = warm_median(lambda b: api.compress_many(
        b, "bzip2", BZIP2_LEVEL, device="cuda"), batches)
    log("bzip2-encode-timing", mb_per_s=f"{total / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        bwt_rounds=bwt.bwt_batched.rounds, card=f"'{smi}'")
    split = stage_split(lambda hook: bzip2.compress_many(
        batches[-1], BZIP2_LEVEL, device="cuda", stage_hook=hook))
    log("bzip2-encode-timing",
        **{f"{k}_ms": f"{v:.2f}" for k, v in split.items()})
    profile_call(lambda: api.compress_many(batches[0], "bzip2", BZIP2_LEVEL,
                                           device="cuda"),
                 "bzip2-encode", phase="bzip2-encode-timing")


def compare_v3w(inputs, cfg):
    """v3w kernel vs plain on the same CUDA tensors: (max abs difference
    at every position, kernel ms, plain ms), each timed on its first call.
    Raises unless all three outputs are equal."""
    from tpz_torch.kernels import parse

    pk1, pk2, _, words, bl = inputs
    args = _parse_args(cfg)[:7]
    before = parse.parse_extend_v3w.launches
    got, ms = timed(lambda: parse.parse_extend_v3w(pk1, pk2, words, bl,
                                                   *args))
    if parse.parse_extend_v3w.launches != before + 1:
        raise RuntimeError("v3w wrapper did not launch its kernel")
    want, plain_ms = timed(lambda: parse.parse_extend_v3w_plain(
        pk1, pk2, words, bl, *args, group=pk1.shape[0]))
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    if err:
        raise RuntimeError(f"v3w kernel disagrees with plain: {err}")
    return got, err, ms, plain_ms


def phase_parse_kernels_8_9(headline, small):
    """#8 and #9 through their public functions (no codec path reaches
    either, as in the reference): greedy_parse on the headline gzip
    parse's lengths, whose token set it must give back, and #8 against
    its doubling; parse_extend_v3w against its plain version on the 1 MiB
    inputs (greedy and lazy) and at the headline, and against #1 at
    n_extend=1 at live positions. Returns the kernel-line rows and
    launches of #8 and #9."""
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import parse

    err9 = 0
    for name, data in small.items():
        for level in (1, 6):
            cfg = DeflateConfig(level=level)
            _, e, _, plain_ms = compare_v3w(parse_inputs([data], cfg, "cuda"),
                                            cfg)
            err9 = max(err9, e)
            log("parse-kernels-8-9", input=name, level=level, lazy=cfg.lazy,
                v3w_max_abs_err=err9, v3w_plain_ms=f"{plain_ms:.1f}")

    cfg = DeflateConfig(level=LEVEL)
    inputs = parse_inputs(headline, cfg, "cuda")
    pk1, pk2, cap_at, words, bl = inputs
    args = _parse_args(cfg)
    got9, dt9, c9 = drive("parse-kernels-8-9", "parse_extend_v3w",
                          lambda: parse.parse_extend_v3w(pk1, pk2, words, bl,
                                                         *args[:7]),
                          {"v3w": parse.parse_extend_v3w})
    pos = torch.arange(pk1.shape[1], device=pk1.device)
    live = pos[None, :] < bl[:, None]
    want1 = parse.parse_extend_v3(*inputs, *args[:7], 1)
    e1 = max(int(((g - w).abs() * live).max()) for g, w in zip(got9, want1))
    if e1:
        raise RuntimeError(f"v3w kernel disagrees with #1 at n_extend=1: {e1}")
    _, e, _, v3w_plain_ms = compare_v3w(inputs, cfg)
    err9 = max(err9, e)
    _, v3w_ms = timed(lambda: parse.parse_extend_v3w(pk1, pk2, words, bl,
                                                     *args[:7]), 5)
    mlen9 = got9[1]
    v3w_bound = bound([pk1, words, bl, got9[0]], int(
        (got9[0] > 0).sum()) * OPS_V3W_TOKEN + int(
        (torch.clamp(mlen9 - cfg.screen_bytes, min=0) // 4).sum())
        * OPS_V3W_EXTEND)
    log("parse-kernels-8-9", input="headline", blocks=pk1.shape[0],
        restart=cfg.restart, lazy=cfg.lazy, v3w_cold_s=f"{dt9:.3f}",
        v3w_launches=c9["v3w"], v3w_vs_v3_n_extend_1_err=e1,
        v3w_max_abs_err=err9, v3w_ms=f"{v3w_ms:.3f}",
        v3w_plain_ms=f"{v3w_plain_ms:.3f}",
        v3w_bound_ms=f"{v3w_bound['bound_ms']:.4f}")
    del got9, want1

    visited, mlen, mdist = parse.parse_extend_v3(*inputs, *args)
    (tok, _, ntok), dt8, c8 = drive(
        "parse-kernels-8-9", "greedy_parse",
        lambda: parse.greedy_parse(mlen, mdist, bl), {"reach": parse.reach_walk})
    if not torch.equal(tok, (visited > 0) & live):
        raise RuntimeError("greedy_parse lost the headline parse's tokens")
    step = torch.where(mlen >= 3, mlen, 1).to(torch.int32).contiguous()
    got8, _ = timed(lambda: parse.reach_walk(step))
    want8, reach_plain_ms = timed(
        lambda: parse._reach_doubling(step.to(torch.int64)).to(torch.int32))
    err8 = int((got8 - want8).abs().max())
    if err8:
        raise RuntimeError(f"reach kernel disagrees with plain: {err8}")
    _, reach_ms = timed(lambda: parse.reach_walk(step), 5)
    reach_bound = bound([step, got8], int(got8.sum()) * OPS_REACH_STEP)
    log("parse-kernels-8-9", input="headline", rows=step.shape[0],
        tokens=int(ntok.sum()), visited=int(got8.sum()),
        reach_cold_s=f"{dt8:.3f}", reach_launches=c8["reach"],
        token_set_equal=True, reach_max_abs_err=err8,
        reach_ms=f"{reach_ms:.3f}", reach_plain_ms=f"{reach_plain_ms:.3f}",
        reach_bound_ms=f"{reach_bound['bound_ms']:.4f}")
    return ({"max_abs_err": err8, "ms": reach_ms, "plain_ms": reach_plain_ms,
             **reach_bound}, c8["reach"],
            {"max_abs_err": err9, "ms": v3w_ms, "plain_ms": v3w_plain_ms,
             **v3w_bound}, c9["v3w"])


def main() -> int:
    import tpz_torch  # noqa: F401 — fails at once outside a checkout
    from tpz_torch.utils import corpus
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
    del blobs
    parse_v1, lz_walk = phase_lzhuf_kernels(small["mixed"], batches[0])
    lz_blobs, lz = phase_lzhuf_slice(batches[0], small["mixed"])
    phase_lzhuf_timing(batches[1:], batches[0], lz_blobs, smi)
    phase_lzhuf_profile(batches[0], lz_blobs)
    del lz_blobs
    bz_blobs, stdlib_blob, cat, small_bz = bzip2_inputs(batches[0])
    bz_walk, bz_ibwt = phase_bzip2_kernels(small_bz, bz_blobs)
    bz = phase_bzip2_slice(batches[0], bz_blobs, stdlib_blob, *cat)
    phase_bzip2_timing(batches[0], bz_blobs, smi)
    mtf_row = phase_bzip2_encode_kernels(batches[0])
    mtf_n = phase_bzip2_encode_slice(batches[0], bz_blobs)
    del bz_blobs
    phase_bzip2_encode_timing(batches[1:], smi)
    reach, reach_n, v3w, v3w_n = phase_parse_kernels_8_9(batches[0], small)
    # Each kernel's launches come from its own main-path call: gzip encode
    # (#1), gzip decode (#2, #3), lh5 encode (#4), lh5 decode (#5), bzip2
    # decode (#6, #7), the public functions greedy_parse (#8) and
    # parse_extend_v3w (#9), bzip2 encode (the MTF encode).
    rows = [("parse_walk_v3", "parse_walk.cu", "tpz/kernels/parse.py:464",
             launches, kern),
            ("symbol_walk", "symbol_walk.cu",
             "tpz/kernels/inflate_pipeline.py:55", dec["walk"], walk),
            ("resolve_copy_machine", "resolve_walk.cu",
             "tpz/kernels/resolve_walk.py:91", dec["resolve"], resolve),
            ("parse_walk_v1", "parse_v1_walk.cu", "tpz/kernels/parse.py:71",
             lz["parse_v1"], parse_v1),
            ("lzhuf_walk", "lzhuf_walk.cu", "tpz/kernels/lzhuf_walk.py:93",
             lz["walk"], lz_walk),
            ("bzip2_walk", "bzip2_walk.cu", "tpz/kernels/bzip2_walk.py:334",
             bz["walk"], bz_walk),
            ("ibwt_walk", "ibwt_walk.cu", "tpz/kernels/ibwt_walk.py:150",
             bz["ibwt"], bz_ibwt),
            ("reach_walk", "reach_walk.cu", "tpz/kernels/parse.py:29",
             reach_n, reach),
            ("parse_walk_v3w", "parse_v3w_walk.cu", "tpz/kernels/parse.py:211",
             v3w_n, v3w),
            ("mtf_encode", "mtf_encode.cu", "tpz/kernels/mtf.py:36", mtf_n,
             mtf_row)]
    # None of these walks has one PyTorch call that computes its function.
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"tpz_torch/csrc/{src}",
        "replaces": where, "launches": n, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}
        for name, src, where, n, k in rows]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
