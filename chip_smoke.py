#!/usr/bin/env python3
"""Smoke run of the tpz_torch gzip, LZHUF and bzip2 encode and decode
paths, of the v3w parse walk no codec path reaches, of the streaming
encode and decode, raw LZSS, the checksums, the CLI and the sharded
shape (mesh encodes, the sharded encode step, span sharding with a real
two-process job), on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device   the card's name and power limit, torch and CUDA versions
  2. build    nvcc builds the CUDA kernels, g++ the C++ oracle
  3. kernel   the parse-walk kernel against its plain torch version, on
              1 MiB of corpus.mixed and of corpus.repetitive (nearly
              every position saturates) at levels 1, 6 and 9, and of
              corpus.mixed at restart 0 (one walk a 64 KiB block), exact
              equality (the plain walk on host copies of the inputs),
              then both timed at the headline shape (NB = 512 blocks,
              restart 16384)
  4. screen-kernel
              the v3 screen's scan kernel (matchfinder.suffix_screen)
              against the plain screen (suffix_screen_w_chunked) on the
              card at the headline layout, level 6: pk1, pk2 and cap_at
              equal at every column, one launch a chunk of SCREEN_CHUNK
              rows; the wrapper (sorts and scans, mean of 5), the scan
              launches alone (mean of 5) and the plain screen (one call)
              timed, the scans beside their bound (the permutation and the
              words read once, pk1 and pk2 written once, at 3.35 TB/s)
  5. bitpack-kernel
              the DEFLATE bit packer's kernel (bitpack.pack_deflate)
              against the plain packer (assemble_stream_v2) on the inputs
              one headline gzip encode's plan stage makes, level 6: every
              word equal, one launch a call; the wrapper (mean of 5), the
              launch alone on the same words (mean of 5; it leaves them as
              they are) and the plain packer (one call) timed, the launch
              beside its bound (its inputs read once, the words written
              once, at 3.35 TB/s)
  6. slice    tpz_torch.api.compress_many on 2 x 16 MiB of corpus.mixed,
              gzip level 6, device "cuda": bodies equal the oracle's bytes,
              gzip.decompress round-trips, the parse walk and the screen
              launched, the pack kernel once
  7. decode-kernels
              the symbol-walk kernel against its plain torch version
              (exact markers) and the copy-machine kernel against the
              plain doubling resolve (exact bytes): 1 MiB of
              corpus.mixed and of corpus.repetitive on the TZ-indexed and
              the segmented route, and of corpus.mixed encoded at level
              1; a match-heavy synthetic marker stream
              (dist 1-4 runs, copies 32 KiB back) with dist_bias 0 and 1,
              at 2^24 positions (one copy-machine launch, chains across
              every segment) and at 2^24 + 2^20 (the chunked route, two
              launches); then at 16 MiB a TZ-indexed member and the
              segmented layout of a phase-6 gzip body (the headline
              dispatch's own input, one launch), both kernels timed there
              beside their plain versions (the copy machine per 16 MiB
              span: its launch alone, at three segment lengths, and
              through its wrapper); the walk also on the headline layout
              with bits flipped mid-chain in eight chains, and with one
              record a lane (SPEC_RECORDS = 1), which sends most lane
              boundaries the slow route; each walk logs its lane
              boundaries met in pass B, carried through in pass B (the
              slow route) and re-walked in the stitch; the
              plain walk runs on host copies of the walk's inputs
  8. decode-slice
              api.decompress_many on the 2 x 16 MiB gzip blobs of phase 6,
              api.decompress on a 16 MiB TZ-indexed member, a stdlib gzip
              and a stdlib zlib stream, device "cuda": every output equals
              its input; on each of the four paths, with the counts set to
              0 just before it, both decode kernels launched and nothing
              declined to the host; a corrupt gzip stream raises on the
              card the error that device "cpu" raises
  9. lzhuf-kernels
              the v1 parse-walk kernel against its plain torch version
              (exact reach and lengths) on the blocks of 1 MiB of
              corpus.mixed at lh5 and lh7 (lh5 also with lazy=True) and
              on the headline batch's blocks at lh5; the LZHUF token-walk kernel against its plain
              version (exact markers) and the copy machine at dist_bias 1
              against the plain resolve (exact bytes) on the segmented
              layout of 1 MiB lh5 and lh7 streams and of a 16 MiB lh5
              stream of the headline batch (the plain token walk on host
              copies of its inputs); each kernel timed beside its plain
              version at the headline shape (the token walk with its
              shared bytes and blocks resident per SM); the token walk
              also timed there at 32 lanes of 32 phase walks, 64 of 16
              and the default (each logging its lane boundaries resolved
              by a phase walk and by the slow route, and the largest
              entry offset past a guess; lzhuf_lanes.py times more), and
              with one phase walk a lane (SPEC_PHASES = 1), which sends
              most lane boundaries the slow route (the phase fails
              unless it does); every one exact. Its last line
              (lzhuf-pack-kernel): the LZHUF bit packer's kernel
              (lzhuf_pipeline.pack_words) against the plain packer
              (pack_words_plain) on the inputs one headline lh5 encode's
              plan stage makes: every word equal, one launch a call; the
              wrapper (mean of 5), the launch alone on the same words
              (mean of 5; it leaves them as they are) and the plain packer
              (one call) timed, the launch beside its bound (its inputs
              read once, the words written once, at 3.35 TB/s)
 10. lzhuf-slice
              api.compress_many on the headline batch at lh5, one 16 MiB
              buffer of it at lh7 and 1 MiB at lh4 and lh6, device "cuda":
              every body equals the oracle's lzhuf encode (max_chain 16);
              then api.decompress_many of each gives the input back. Each
              call runs with the launch counts set to 0 just before it and
              read just after: the v1 parse walk and the LZHUF pack on
              encode (the pack once a call), the token walk and the copy
              machine on decode; nothing declines to the host.
              Corrupt lh5 streams decode on the card as on device "cpu":
              one raises the same error, one gives the same bytes
 11. lzhuf-profile
              one more warm lh5 encode of the headline batch and decode of
              its blobs under torch.profiler: host wall time, device busy
              time (the union of the kernel, memcpy and memset intervals
              inside the call), the device's idle share (1 - busy / wall)
              the device time of each CUDA kernel (a wrapper's .kernels)
              of the path's wrappers and the device ops that took the most
              time; the trace must hold every CUDA kernel of each wrapper
              the call launched
 12. bzip2-kernels
              the bzip2 symbol-walk kernel against its plain torch version
              (exact records and meta; the plain walk on host copies of
              the inputs) on small stdlib and oracle streams at levels 1
              and 9 and on a corrupted one, then on three 64 KiB level-1
              blocks whose records passes wrap their ring several times,
              the last corrupted three quarters in, all at the default
              MTF^-1
              segment length (bzip2_walk.REC_SEG records) and at 32, so
              that cuts fall inside runs and mid-block; the iBWT kernels
              against their plain version (exact bytes and flags) on the
              small blocks, a periodic block and the headline batch's last
              columns (the 2 x 16 MiB corpus.mixed batch, oracle bzip2
              level 9), all at the decode's splitter stride; both kernels
              timed at the headline shape, the iBWT also at the candidate
              strides around the decode's (IBWT_STRIDES), which must give
              the same bytes and flags
 13. bzip2-slice
              api.decompress_many on the headline blobs, api.decompress on
              a 16 MiB stdlib bz2 level 9 stream and on a two-stream
              concatenation, device "cuda": every output equals its input,
              each path (counts set to 0 just before it) one dispatch that
              launched each kernel once, nothing sent to decompress's
              second route (host symbol decode) or the host decoder
 14. bzip2-profile
              one decompress_many call on the headline blobs under
              torch.profiler (as phase 11: device busy time, idle share,
              the time of each of the walk's kernels (records, labels,
              lists, bytes) and the iBWT's (walk, stitch, place), and the
              trace must hold every kernel of each wrapper the call
              launched)
 15. bzip2-encode-kernels
              the MTF-encode kernel against its plain version (exact
              ranks) on the symbols and the selectors (alpha 6) of small
              buffers and of the headline batch at level 9, built by the
              encode's own stages, the small ones at the default segment
              length (mtf.MTF_SEG symbols) and at 32; the headline's calls
              timed
 16. bzip2-encode-slice
              api.compress_many on the headline batch at level 9, device
              "cuda": the streams equal the oracle's blobs of phase 12, bz2
              and the port's decode give the inputs back, one dispatch
              (counts set to 0 just before it) launched the MTF kernel
              twice (symbols, selectors); api.compress of 1 MiB at level
              1, b"", b"a" and bytes(range(256)) * 40 the same; the 1 MiB
              buffer again in dispatches of at most 4 blocks
 17. bzip2-encode-profile
              one compress_many call on the headline batch at level 9
              under torch.profiler (as phase 14; the MTF's kernels, keys
              and walk, for the symbols and the selectors together)
 18. parse-kernels-8-9
              the v3w form of the v3 walk kernel against its plain version
              on 1 MiB of corpus.mixed and corpus.repetitive at levels 1
              and 6 (greedy, lazy) and at the headline, and against #1 at
              n_extend=1 at live positions; greedy_parse on the headline
              gzip parse's lengths gives back its token set, the reach
              kernels equal the pointer doubling there and on synthetic
              rows at every tile of REACH_TILES (walks that never meet,
              steps past whole tiles and of 65,535-70,000, steps below 1
              and at or past N, N = 65,536 + 96, one row); each called
              through its public function with its count set to 0, both
              timed at the headline, the reach walk at each tile of
              REACH_TILES; one greedy_parse call under torch.profiler (as
              phase 11; the trace must hold both reach kernels)
 19. decode-profile
              one gzip decode call of phase 6's blobs under torch.profiler
              (as phase 11; the trace must hold the symbol walk's and the
              copy machine's kernels)
 20. encode-profile
              one warm gzip encode call of the headline batch under
              torch.profiler (as phase 11; the trace must hold the parse
              walk's, the screen's and the pack's kernels)
 21. stream-encode
              api.CodecStream on the card: gzip on phase 6's first 16 MiB
              buffer in 1 MiB writes (Action.RUN, then FINISH) equals
              api.compress and the oracle's body; flushed every 4 MiB, it
              equals the header, the oracle's sync-flushed segments, its
              final segment and the trailer, and stdlib gzip reads it;
              zlib and deflate the same at 1 MiB; each stream launches the
              v3 parse walk exactly once (counts set to 0 just before it);
              both gzip streams timed (warm median of 3, MB/s); a bzip2
              stream flushed once is two streams that bz2 reads; an lh5
              flush raises DataError
 22. stream-decode
              api.DecodeStream (on the host, as the reference's) in 64 KiB
              writes on phase 6's gzip blob, a two-member gzip, a stdlib
              zlib stream, phase 13's level-9 bzip2 blob and phase 10's
              lh5 blob: each output equals its input, half of each blob
              raises UnexpectedEof; MB/s each
 23. lzss     formats() equals the reference's list and "bgzf"; 16 MiB
              of raw LZSS through api.compress / decompress on "cuda" (the
              codec runs on the host): bytes equal to the oracle's, the
              round trip exact; MB/s both ways
 24. checksums
              the CRC lane kernel against its plain version, exactly (the
              chunk registers and the combined one), on 1 MiB of
              corpus.mixed and corpus.repetitive, on 1, 3, 4,097 bytes and
              16 MiB + 5, both variants, and on a view 3 bytes off a
              16-byte boundary at each chunk length of CRC_CHUNKS; crc32
              equals zlib (reflected) and the oracle (msb), adler32 zlib,
              crc32_combine the CRC of the concatenation; crc32 of 16 MiB
              on the card (its count set to 0 just before) launches the
              kernel once; the kernel timed at 16 MiB at each chunk length
              beside its plain version and its bound
 25. cli      python -m tpz_torch selftest -n 1048576 --device cuda as a
              subprocess (every format OK), then compress / decompress
              file round trips at gzip and lh5
 26. sharded-gzip
              tpz_torch.parallel.mesh.sharded_compress of 64 MiB (the
              first four headline buffers) on make_mesh(4): four 16 MiB
              shards on cuda:0, one gzip member each, equal to members
              built from oracle.deflate_encode; gzip reads it; #1 and the
              pack kernel launched 4 times, the screen kernel once a chunk
              of SCREEN_CHUNK rows
              of each shard, no host decline; warm median of 3 (MB/s); the
              ratio cost of the cut against one member of the whole 64 MiB
 27. sharded-bzip2
              sharded_compress_bzip2 of the same 64 MiB at level 9 on
              make_mesh(4) and make_mesh(1): equal bytes, bz2 reads them,
              MTF launches counted; warm median of 3
 28. sharded-step
              sharded_encode_step(make_mesh(4), k=8, window=32768,
              block=65536) on 16 MiB: #8 launched 4 times, every token
              count positive, is_token equal to the plain reach route;
              find_matches at 1 MiB equal on the card and the CPU;
              ragged_all_gather equal to ring_all_gather on phase 26's
              member bodies
 29. distributed
              parallel.distributed.compress_sharded of the 64 MiB in 16
              MiB spans, gzip and bzip2; a run with span 1 failing raises
              and its resume gives the same bytes; a two-process job
              (torch.multiprocessing, two ranks on cuda:0 joined by gloo
              over 127.0.0.1: rank 1 writes its spans, both meet at a
              barrier, rank 0 assembles) gives the one-process bytes
The last phase line gives the script's seconds so far. A JSON record of
the kernels (launches from each one's main-path calls:
gzip encode and sharded_compress (#1, the screen and the pack), gzip decode, lh5 encode (#4 and
the LZHUF pack), lh5 decode,
bzip2 decode, the public functions of #8 (and sharded_encode_step) and
#9, bzip2 encode and sharded_compress_bzip2, checksums.crc32; times and
bounds at the headline shapes) comes before the card's name and power
limit; the last
line is {"ok": true, "device": {...}}. Needs the repository checkout
around it.
"""

from __future__ import annotations

import bz2
import gzip
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from benchmark import traceops, work
from tpz_torch.utils.corpus import make_corpus

MIB = 1 << 20
HEADLINE_BYTES = 16 * MIB
HEADLINE_BUFFERS = 2
LEVEL = 6
TIMING_ITERS = 3
LZHUF_METHOD = "lh5"
BZIP2_LEVEL = 9
# The streaming phases: CodecStream writes of STREAM_RUN bytes (each an
# Action.RUN, FLUSH or FINISH), a gzip flush every STREAM_FLUSH bytes, and
# DecodeStream writes of STREAM_PIECE bytes.
STREAM_RUN = MIB
STREAM_FLUSH = 4 * MIB
STREAM_PIECE = 64 * 1024
# crc32_lanes: its chunk lengths timed at 16 MiB.
CRC_CHUNKS = (128, 256, 1024, 4096)
# The iBWT's candidate splitter strides around the decode's own
# (ibwt_walk.IBWT_SEG), timed at the headline; ibwt_stride.py times a
# wider range.
IBWT_STRIDES = (16, 64, 128)
# The reach walk's (#8) tile lengths timed at the headline; the fastest is
# parse.REACH_TILE.
REACH_TILES = (4096, 8192, 16384, 32768)
# The MTF kernels' second segment length on the small inputs: short enough
# that segment cuts fall inside runs and mid-block.
MTF_SEG_CHECK = 32
# Phase 12's long blocks, level 1: each runs its records pass through the
# ring of csrc/bzip2_walk.cu (kRing entries between its decoder thread and
# its RLE2 warp) several times over. The plain walk runs them on the host
# (one Python trip per symbol, ~2 ms each on the card).
LONG_BLOCK_BYTES = 64 * 1024
BZIP2_RING = 8192

# A kernel's bound is the larger of its bytes (each input read once, each
# array the kernel writes written once) over the card's memory rate
# (benchmark/peaks.json) and its int32 operations, hand-counted a trip
# (OPS_*), over the card's int32 rate. NVIDIA's H100 SXM datasheet
# (700 W): 67 T/s float32 outside the tensor cores, i.e. 132 SMs x 128
# FP32 lanes x 2 (an FMA) x 1.98 GHz. An SM has 64 INT32 lanes (NVIDIA's
# Hopper architecture whitepaper), so int32 issues at 67e12 / 2 / 2 per
# second.
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
OPS_V1_VISIT = 31          # #4: a visited position (counted from the
                           # serial walk; the function's own work)
OPS_V1_EXTEND = 16         # ... one 4-byte extension compare
OPS_V3_TOKEN = 15          # #1: a token on the mark fast path (counted
                           # from the serial walk; the function's own work)
OPS_V3_EXTEND = 12         # ... one 4-byte extension compare
OPS_COPY_POSITION = 16     # #3: a position's state and its check
                           # (counted from the serial copy machine)
OPS_COPY_MATCHED = 12      # ... the copy of one matched position
OPS_IBWT_STEP = 17         # #7: a node's step (its load, the successor
                           # test, its byte out; the function's own work)
OPS_REACH_STEP = 8         # #8: a visited position (its load, step, mark;
                           # counted from the serial walk, the function's
                           # own work)
OPS_V3W_TOKEN = 36         # #9: a token through TOK and FIN of the serial
                           # walk (the function's own work, whatever the
                           # design)
OPS_V3W_EXTEND = 12        # ... one 4-byte extension compare
# The bzip2 symbol walk (#6) and the MTF encode are counted from the work
# of the function itself, whatever the design: a move-to-front moves as
# many list entries as the symbol's rank, which this run's data gives.
OPS_HUFFMAN_SYMBOL = 5     # #6: peek the code's bits, table load, length,
                           # bit position, group count
OPS_RLE2_RUN = 2           # #6: a run symbol's shifted add to its run
OPS_MTF_INVERSE = 4        # #6: a record's read at its rank, write at the
                           # front, its compose and store
OPS_MTF_ENCODE = 4         # MTF: a symbol's load, rank lookup, write at
                           # the front and store of its rank
OPS_MTF_MOVE = 1           # both: each list entry moved
# crc32_lanes: its byte-table loads, one a byte.
OPS_CRC_BYTE = 1


def hbm_bytes_per_s() -> float:
    """The card's memory rate, from benchmark/peaks.json; a card the table
    lacks raises, since no other card's rate stands in for it."""
    card = torch.cuda.get_device_name()
    rate = work.hbm_bytes_per_s(card)
    if rate is None:
        raise RuntimeError(f"no memory rate for {card!r} in "
                           f"{work.PEAKS}")
    return rate


def bound(tensors, ops) -> dict:
    """bound_ms and bound_by for a kernel call that reads or writes each
    of `tensors` once and does `ops` int32 operations."""
    return bound_bytes_ops(sum(t.numel() * t.element_size()
                               for t in tensors), ops)


def bound_bytes_ops(nbytes, ops) -> dict:
    """bound_ms and bound_by for a kernel call that moves `nbytes` and
    does `ops` int32 operations."""
    ms_bytes = nbytes / hbm_bytes_per_s() * 1e3
    ms_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


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
    pk1, pk2, cap_at = mf.suffix_screen(
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


def on_host(fn, *args):
    """fn(*args) on host copies of its tensor arguments, on one torch
    thread; its tensor results come back to the card. The plain walks take
    one Python trip per token or symbol, each a few tiny ops: on the host
    a trip costs a fraction of what its launches cost on the card, and
    intra-op threads only slow it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in args))
    finally:
        torch.set_num_threads(threads)
    if isinstance(out, tuple):
        return tuple(o.cuda() for o in out)
    return out.cuda()


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


def compare_parse(inputs, cfg, restart=None, host=False):
    """Kernel vs plain on the same CUDA tensors (at `restart` in place of
    the config's, where given; with `host`, the plain walk on host copies
    of them). Returns (max abs difference over live positions, which must
    be 0; kernel ms; plain ms; the kernel's outputs), each version timed
    on its first call."""
    from tpz_torch.kernels import parse

    args = _parse_args(cfg)
    if restart is not None:
        args = args[:6] + (restart,) + args[7:]
    before = parse.parse_extend_v3.launches
    got, ms = timed(lambda: parse.parse_extend_v3(*inputs, *args))
    if parse.parse_extend_v3.launches != before + 1:
        raise RuntimeError("parse walk wrapper did not launch its kernel")
    if host:
        want, plain_ms = timed(lambda: on_host(
            parse.parse_extend_v3z, *inputs, *args, inputs[0].shape[0]))
    else:
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

    worst = 0
    for name, data in small.items():
        for level in (1, 6, 9):
            cfg = DeflateConfig(level=level)
            inputs = parse_inputs([data], cfg, "cuda")
            restarts = (None, 0) if name == "mixed" and level == LEVEL else (
                None,)
            for restart in restarts:
                err, ms, plain_ms, _ = compare_parse(inputs, cfg, restart,
                                                     host=True)
                worst = max(worst, err)
                log("kernel", input=name, level=level,
                    restart=cfg.restart if restart is None else restart,
                    blocks=16, max_abs_err=err, first_call_ms=f"{ms:.3f}",
                    plain_ms=f"{plain_ms:.1f}")
    cfg = DeflateConfig(level=LEVEL)
    inputs = parse_inputs(headline, cfg, "cuda")
    err, cold_ms, plain_ms, got = compare_parse(inputs, cfg)
    worst = max(worst, err)
    args = _parse_args(cfg)
    _, ms = timed(lambda: parse.parse_extend_v3(*inputs, *args), 5)
    # The kernel writes visited, mlen and mdist. The serial walk extends a
    # saturated token from its screen, 4 bytes a compare.
    b = bound([*inputs, *got], int((got[0] > 0).sum()) * OPS_V3_TOKEN
              + int((torch.clamp(got[1] - cfg.screen_bytes, min=0)
                     // 4).sum()) * OPS_V3_EXTEND)
    log("kernel", input="headline", blocks=inputs[0].shape[0],
        restart=cfg.restart, max_abs_err=err, ms=f"{ms:.3f}",
        first_call_ms=f"{cold_ms:.3f}", plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{b['bound_ms']:.4f}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **b}


def screen_inputs(datas, device="cuda"):
    """The v3 screen's inputs (words, span_off, span_len) for `datas`,
    built by the encode's own stages on `device`."""
    from tpz_torch.kernels import deflate_pipeline as dp

    span, so, sl, bl, _, bfinal, _ = (
        torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a
        for a in dp.span_layout(datas))
    return dp._zero_past_end(dp._make_words(span), bl, bfinal), so, sl


def phase_screen_kernel(headline):
    """Phase 4: the v3 screen's scan kernel against the plain screen at the
    headline layout, level 6; the wrapper, the scan launches alone and
    the plain screen timed, the scans beside their bound."""
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import deflate_pipeline as dp
    from tpz_torch.kernels import matchfinder as mf

    cfg = DeflateConfig(level=LEVEL)
    words, so, sl = screen_inputs(headline)
    NB, M = words.shape
    chunk = dp.SCREEN_CHUNK
    args = (words, so, sl, cfg.max_chain, mf.WINDOW, mf.BLOCK, mf.MAX_MATCH,
            cfg.screen_bytes, cfg.restart, chunk)
    before = mf.suffix_screen.launches
    got, cold_ms = timed(lambda: mf.suffix_screen(*args))
    launches = mf.suffix_screen.launches - before
    if launches != -(-NB // chunk):
        raise RuntimeError(f"screen wrapper launched {launches} times")
    want, plain_ms = timed(lambda: mf.suffix_screen_w_chunked(*args))
    differ = {name: int((g != w).sum())
              for name, g, w in zip(("pk1", "pk2", "cap_at"), got, want)}
    if any(differ.values()):
        raise RuntimeError(f"screen kernel disagrees with plain: {differ}")
    del want
    _, ms = timed(lambda: mf.suffix_screen(*args), 5)
    # The scan launches alone, on each chunk's sort.
    rows = [slice(r, r + chunk) for r in range(0, NB, chunk)]
    perms = [mf._screen_perm(words[r], so[r], sl[r], mf.WINDOW, mf.BLOCK,
                             cfg.screen_bytes // 4) for r in rows]
    pk1, pk2 = torch.empty_like(got[0]), torch.empty_like(got[1])

    def scans():
        for r, perm in zip(rows, perms):
            mf._screen_scan(perm, words[r], so[r], sl[r], pk1[r], pk2[r],
                            cfg.max_chain, mf.WINDOW, mf.BLOCK,
                            mf.MAX_MATCH, cfg.screen_bytes, cfg.restart)

    _, scan_ms = timed(scans, 5)
    if not (torch.equal(pk1, got[0]) and torch.equal(pk2, got[1])):
        raise RuntimeError("screen scans alone disagree with the wrapper")
    # Read once: the permutation and the words; written once: pk1, pk2.
    b = bound([*perms, words, pk1, pk2], 0)
    log("screen-kernel", blocks=NB, chunks=launches, level=LEVEL,
        r_neighbors=cfg.max_chain, screen_bytes=cfg.screen_bytes,
        columns_differ=0, wrapper_ms=f"{ms:.3f}",
        first_call_ms=f"{cold_ms:.3f}", scan_ms=f"{scan_ms:.3f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b['bound_ms']:.4f}")
    return {"max_abs_err": 0, "ms": scan_ms, "plain_ms": plain_ms, **b}


def phase_bitpack_kernel(headline):
    """Phase 5: the DEFLATE bit packer's kernel against the plain packer
    at the headline layout, level 6, on the inputs the encode's own plan
    stage makes (caught from one gzip encode call); the wrapper, the
    launch alone and the plain packer timed, the launch beside its
    bound."""
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import bitpack
    from tpz_torch.kernels import deflate_pipeline as dp

    pack, launch = bitpack.pack_deflate, bitpack._pack_launch
    seen = []
    bitpack._pack_launch = lambda *a: seen.append(a) or launch(*a)
    try:
        dp.compress_many(headline, DeflateConfig(level=LEVEL), "cuda")
    finally:
        bitpack._pack_launch = launch
    (*args, words), = seen
    args = (*args, words.numel())
    before = pack.launches
    got, cold_ms = timed(lambda: pack(*args))
    if pack.launches != before + 1:
        raise RuntimeError(f"pack wrapper launched "
                           f"{pack.launches - before} times")
    want, plain_ms = timed(lambda: bitpack.to_i32(
        bitpack.assemble_stream_v2(*args)))
    differ = int((got != want).sum())
    if differ:
        raise RuntimeError(f"pack kernel disagrees with plain: {differ} of "
                           f"{want.numel()} words")
    del want
    _, ms = timed(lambda: pack(*args), 5)
    # The launch alone, again and again on the same words: each launch
    # stores or ORs the same bits, so the words stay as they were.
    words = got.clone()
    _, launch_ms = timed(lambda: launch(*args[:10], words), 5)
    if not torch.equal(words, got):
        raise RuntimeError("pack launches alone disagree with the wrapper")
    # Read once: the four position arrays, the table, the row vectors and
    # the header slots; written once: the words.
    b = bound([*args[:9], *args[9], got], 0)
    NB = args[0].shape[0]
    log("bitpack-kernel", blocks=NB, level=LEVEL, words=got.numel(),
        words_differ=0, wrapper_ms=f"{ms:.3f}",
        first_call_ms=f"{cold_ms:.3f}", launch_ms=f"{launch_ms:.3f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b['bound_ms']:.4f}")
    return {"max_abs_err": 0, "ms": launch_ms, "plain_ms": plain_ms, **b}


def phase_slice(batch):
    from tpz_torch import api, oracle
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import bitpack
    from tpz_torch.kernels import matchfinder as mf
    from tpz_torch.kernels import parse

    blobs, dt, c = drive("slice", "gzip-encode", lambda: api.compress_many(
        batch, "gzip", level=LEVEL, device="cuda"),
        {"parse": parse.parse_extend_v3, "screen": mf.suffix_screen,
         "pack": bitpack.pack_deflate})
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
        ratio=f"{ratio:.4f}", cold_s=f"{dt:.3f}", parse_launches=c["parse"],
        screen_launches=c["screen"], pack_launches=c["pack"],
        oracle_identical=True)
    if c["pack"] != 1:
        raise RuntimeError(f"slice: the pack kernel launched {c['pack']} "
                           f"times (want 1)")
    return c, blobs


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


def compare_walk(t, want=None):
    """Symbol-walk kernel vs plain on the same CUDA tensors (the plain
    walk on host copies of them, unless its markers `want` are given):
    (markers, max abs difference, kernel ms, plain ms, [lane boundaries
    met in pass B, carried through in pass B, re-walked in the stitch]),
    each timed on its first
    call. The kernel gets the layout's end-bit hint, as the decode does.
    Raises unless the markers are equal."""
    from tpz_torch.kernels import inflate_pipeline as ip

    args = ip._walk_args(t)
    before = ip.symbol_walk.launches
    got, ms = timed(lambda: ip.symbol_walk(
        *args, walk_end_bit=t["walk_end_bit"]))
    if ip.symbol_walk.launches != before + 1:
        raise RuntimeError("symbol walk wrapper did not launch its kernel")
    stats = ip.symbol_walk.last_stats.tolist()
    plain_ms = None
    if want is None:
        want, plain_ms = timed(lambda: on_host(ip.symbol_walk_plain, *args))
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise RuntimeError(f"symbol-walk kernel disagrees with plain: {err}")
    return got, err, ms, plain_ms, stats


def compare_resolve(dense, dist_bias=0, launches=None):
    """Copy machine (resolve_dense on a CUDA tensor) vs the plain doubling
    resolve over the whole span: max abs byte difference, which must be
    0. `launches`, where given, is the number of copy-machine launches
    the span must take (1 up to 2^24 positions)."""
    from tpz_torch.kernels import resolve_walk as rw

    before = rw.resolve_copy_machine.launches
    got = rw.resolve_dense(dense, dist_bias)
    n = rw.resolve_copy_machine.launches - before
    if n == 0 or launches is not None and n != launches:
        raise RuntimeError(f"copy machine: {n} launches for "
                           f"{dense.shape[0]} positions, want {launches}")
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


def dist1_markers(n):
    """A literal, then 258-byte matches at dist 1 to the end: every byte
    copies the one before its match, so the chain of the last byte runs
    through every segment of the span (phase 2's deepest case)."""
    m = np.zeros(n, np.int32)
    m[0] = (1 << 28) | 0x61
    starts = np.arange(1, n, 258)
    m[starts] = (2 << 28) | (1 << 9) | np.minimum(258, n - starts)
    return torch.from_numpy(m).cuda()


def phase_decode_kernels(small, big, body):
    """`big` is 16 MiB of plaintext for the TZ-indexed route; `body` is the
    raw DEFLATE body of one phase-6 gzip blob, whose segmented layout is
    what the headline decode dispatch gives both kernels."""
    from tpz_torch.kernels import inflate_pipeline as ip
    from tpz_torch.kernels import resolve_walk as rw

    err_w = err_r = 0
    for name, data in small.items():
        for route, t in (("indexed", indexed_inputs(data)),
                         ("segmented", segmented_inputs(
                             zlib.compress(data, 6)[2:-4]))):
            markers, e, _, _, stats = compare_walk(t)
            err_w = max(err_w, e)
            err_r = max(err_r, compare_resolve(dense_markers(t, markers)))
            log("decode-kernels", input=name, route=route,
                entries=t["out_len"].shape[0], walk_max_abs_err=e,
                walk_boundaries_met_through_serial=stats,
                resolve_max_abs_err=err_r)
    spans = [("synthetic-runs", rw.MAX_PACKED_SPAN, bias, 1)
             for bias in (0, 1)]
    spans += [("synthetic-runs", rw.MAX_PACKED_SPAN + MIB, bias, 2)
              for bias in (0, 1)]
    spans.append(("dist-1-runs", rw.MAX_PACKED_SPAN, 0, 1))
    for name, n, bias, want in spans:
        m = (synthetic_markers(n, bias, 7 + bias) if name == "synthetic-runs"
             else dist1_markers(n))
        err_r = max(err_r, compare_resolve(m, bias, want))
        _, ms = timed(lambda: rw.resolve_dense(m, bias), 3)
        log("decode-kernels", input=name, positions=n, dist_bias=bias,
            resolve_launches=want, resolve_max_abs_err=err_r,
            resolve_wrapper_ms=f"{ms:.3f}")
        del m

    for name, t in (("16MiB-indexed", indexed_inputs(big)),
                    ("16MiB-segmented-headline", segmented_inputs(body))):
        markers, e, cold_ms, walk_plain_ms, stats = compare_walk(t)
        err_w = max(err_w, e)
        args = ip._walk_args(t)
        hint = t["walk_end_bit"]
        _, walk_ms = timed(lambda: ip.symbol_walk(*args, walk_end_bit=hint),
                           5)
        dense = dense_markers(t, markers)
        err_r = max(err_r, compare_resolve(dense, 0, 1))
        # The copy machine as the main path launches it: once on the whole
        # 16 MiB span. `ms` is its launch alone (phase 1 and phase 2's
        # rounds, pending counts zeroed) on prepared inputs, also at half
        # and twice the default segment; the wrapper adds the boundary
        # carries and the pad.
        by_rows = {}
        for rows in (rw.SEGMENT_ROWS // 2, rw.SEGMENT_ROWS * 2,
                     rw.SEGMENT_ROWS):
            prep = rw._prepare(dense, 0, rows)
            rw._launch(*prep)
            _, by_rows[rows] = timed(lambda: (prep[2].zero_(),
                                              rw._launch(*prep)), 5)
        res_ms = by_rows[rw.SEGMENT_ROWS]
        _, wrap_ms = timed(lambda: rw.resolve_copy_machine(dense), 5)
        rw.resolve_doubling_state(dense)
        _, res_plain_ms = timed(lambda: rw.resolve_doubling_state(dense), 3)
        log("decode-kernels", input=name, entries=args[0].shape[0],
            positions=dense.shape[0], segments=prep[3],
            walk_max_abs_err=e, walk_boundaries_met_through_serial=stats,
            resolve_max_abs_err=err_r,
            walk_ms=f"{walk_ms:.3f}", walk_first_call_ms=f"{cold_ms:.3f}",
            walk_plain_ms=f"{walk_plain_ms:.3f}",
            resolve_16MiB_ms=f"{res_ms:.3f}",
            resolve_16MiB_ms_by_segment_rows=json.dumps(
                {r: round(v, 4) for r, v in sorted(by_rows.items())}),
            resolve_16MiB_wrapper_ms=f"{wrap_ms:.3f}",
            resolve_16MiB_plain_ms=f"{res_plain_ms:.3f}")
    err_w = max(err_w, phase_walk_spec(small, t, markers))
    # The kernels line keeps the headline input's times (the last one).
    walk_bound = bound([*args, markers], walk_ops(
        markers, args[0].numel() + args[3].numel(), OPS_SYMBOL_LITERAL,
        OPS_SYMBOL_MATCH))
    res_bound = bound(prep[:2], copy_ops(prep[0]))
    return ({"max_abs_err": err_w, "ms": walk_ms, "plain_ms": walk_plain_ms,
             **walk_bound},
            {"max_abs_err": err_r, "ms": res_ms, "plain_ms": res_plain_ms,
             **res_bound})


def phase_walk_spec(small, t, want):
    """The symbol walk where its speculation can break: the headline layout
    `t` (plain markers `want`), timed at 32 lanes x 32 records, 64 x 16
    and the default, then with one record a lane, so that most lane
    boundaries take the slow route, and with bits flipped mid-chain in
    eight chains; 1 MiB of corpus.mixed encoded at level 1. Returns the
    largest difference, which must be 0."""
    from tpz_torch import api
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.kernels import inflate_pipeline as ip

    lanes, records = ip.SPEC_LANES, ip.SPEC_RECORDS
    args, hint = ip._walk_args(t), t["walk_end_bit"]
    by_lanes, stats_by_lanes = {}, {}
    try:
        for ip.SPEC_LANES, ip.SPEC_RECORDS in ((32, 32), (64, 16),
                                                (lanes, records)):
            key = f"{ip.SPEC_LANES}x{ip.SPEC_RECORDS}"
            _, by_lanes[key] = timed(
                lambda: ip.symbol_walk(*args, walk_end_bit=hint), 5)
            stats_by_lanes[key] = ip.symbol_walk.last_stats.tolist()
        ip.SPEC_RECORDS = 1
        _, err, ms, _, stats = compare_walk(t, want)
    finally:
        ip.SPEC_LANES, ip.SPEC_RECORDS = lanes, records
    log("decode-kernels", input="16MiB-segmented-headline",
        walk_ms_by_lanes_x_records=json.dumps(
            {k: round(v, 4) for k, v in by_lanes.items()}),
        walk_boundaries_by_lanes_x_records=json.dumps(stats_by_lanes))
    log("decode-kernels", input="16MiB-segmented-headline-one-record",
        walk_max_abs_err=err, walk_boundaries_met_through_serial=stats,
        walk_first_call_ms=f"{ms:.3f}")
    if stats[1] + stats[2] <= stats[0]:
        raise RuntimeError(f"one record a lane: the slow route took only "
                           f"{stats[1] + stats[2]} of the lane boundaries: "
                           f"{stats}")

    words = t["stream_words"].clone()
    lo, hi = t["body_bit_local"].tolist(), t["walk_end_bit"].tolist()
    rng = np.random.default_rng(17)
    for c in range(0, min(len(lo), 64), 8):
        for _ in range(5):
            bit = (lo[c] + hi[c]) // 2 + int(rng.integers(-2000, 2000))
            flip = 1 << (bit & 31)  # as an int32
            words[c, bit >> 5] ^= flip - (1 << 32 if flip >> 31 else 0)
    bad = {**t, "stream_words": words}
    _, e, _, _, stats = compare_walk(bad)
    err = max(err, e)
    log("decode-kernels", input="16MiB-segmented-headline-corrupt",
        chains_corrupted=8, walk_max_abs_err=e,
        walk_boundaries_met_through_serial=stats)

    blob = api.compress_many([small["mixed"]], "gzip", level=1,
                             device="cuda")[0]
    body = blob[len(gzip_codec.header_bytes(1)):-8]
    _, e, _, _, stats = compare_walk(segmented_inputs(body))
    err = max(err, e)
    log("decode-kernels", input="1MiB-mixed-level-1", walk_max_abs_err=e,
        walk_boundaries_met_through_serial=stats)
    return err


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
    blob = corrupt(api.compress(corrupt_data(), "gzip", LEVEL,
                                device="cuda"), 0.5)
    outcome = same_outcome("corrupt gzip", blob, "gzip")
    if outcome == "bytes":
        raise RuntimeError("corrupt gzip: the CRC did not reject it")
    log("decode-slice", path="corrupt-gzip", same_as_cpu=outcome)
    return launches


def corrupt_data() -> bytes:
    """The small buffer that the corrupt-stream checks encode: its plain
    decode on the CPU takes about a second."""
    from tpz_torch.utils import corpus

    return corpus.mixed(6000, seed=3)


def corrupt(blob: bytes, where: float) -> bytes:
    """`blob` with bit 4 of one byte flipped, `where` of the way in (an
    int: that offset)."""
    off = where if isinstance(where, int) else int(len(blob) * where)
    b = bytearray(blob)
    b[off] ^= 0x10
    return bytes(b)


def same_outcome(what: str, blob: bytes, fmt: str) -> str:
    """Decodes `blob` on the card and on the CPU: both must raise the same
    error class and message, or return the same bytes. Returns "bytes",
    or the error's class and message."""
    from tpz_torch import api

    def outcome(device):
        try:
            return ("bytes", api.decompress(blob, fmt, device=device))
        except Exception as e:  # the error is what is compared
            return (type(e).__name__, str(e))

    got, want = outcome("cuda"), outcome("cpu")
    if got != want:
        raise RuntimeError(f"{what}: the card gave {got[0]} "
                           f"{got[1][:80]!r}, the CPU {want[0]} "
                           f"{want[1][:80]!r}")
    return got[0] if got[0] == "bytes" else f"{got[0]}({got[1]!r})"


def phase_decode_profile(blobs) -> None:
    """One gzip decode call of the headline blobs under torch.profiler, as
    phase 11. It runs late: with one more profiled call before phase 14,
    phase 14's trace lost the bzip2 walk's kernels (PERF.md §7)."""
    from tpz_torch import api
    from tpz_torch.kernels import inflate_pipeline as ip
    from tpz_torch.kernels import resolve_walk as rw

    profile_call(lambda: api.decompress_many(blobs, "gzip", device="cuda"),
                 "gzip-decode", {"walk": ip.symbol_walk,
                                 "resolve": rw.resolve_copy_machine},
                 phase="decode-profile")


def phase_encode_profile(batch) -> None:
    """One warm gzip encode call of the headline batch under
    torch.profiler, as phase 11: the parse walk's and the screen's
    kernel time and the call's idle share. It runs after phase 19, for
    the reason phase 19 runs late."""
    from tpz_torch import api
    from tpz_torch.kernels import bitpack
    from tpz_torch.kernels import matchfinder as mf
    from tpz_torch.kernels import parse

    profile_call(lambda: api.compress_many(batch, "gzip", level=LEVEL,
                                           device="cuda"),
                 "gzip-encode", {"parse": parse.parse_extend_v3,
                                 "screen": mf.suffix_screen,
                                 "pack": bitpack.pack_deflate},
                 phase="encode-profile")


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


def compare_parse_v1(inputs, window, lazy=False):
    """v1 parse-walk kernel vs plain on the same CUDA tensors: ((reach,
    mlen), max abs difference, kernel ms, plain ms), each timed on its
    first call. Raises unless both outputs are equal everywhere."""
    from tpz_torch.kernels import lzhuf_pipeline as lp
    from tpz_torch.kernels import parse

    before = parse.parse_extend_v1.launches
    got, ms = timed(lambda: parse.parse_extend_v1(
        *inputs, window, max_match=lp.MAX_MATCH, lazy=lazy))
    if parse.parse_extend_v1.launches != before + 1:
        raise RuntimeError("v1 parse wrapper did not launch its kernel")
    want, plain_ms = timed(lambda: parse.parse_extend_v1_plain(
        *inputs, window, max_match=lp.MAX_MATCH, lazy=lazy))
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


def compare_lzhuf_walk(t, want=None):
    """LZHUF token-walk kernel vs plain on the same CUDA tensors (the plain
    walk on host copies of them, unless its markers `want` are given):
    (markers, max abs difference, kernel ms, plain ms, [lane boundaries
    resolved by a phase walk, walked by the slow route, the largest entry
    offset past a guess]), each timed on its first call. The kernel gets
    the layout's end-bit hint, as the decode does. Raises unless the
    markers are equal."""
    from tpz_torch.kernels import lzhuf_walk as lw

    args = lw._walk_args(t)
    before = lw.lzhuf_walk.launches
    got, ms = timed(lambda: lw.lzhuf_walk(
        *args, walk_end_bit=t["walk_end_bit"]))
    if lw.lzhuf_walk.launches != before + 1:
        raise RuntimeError("lzhuf walk wrapper did not launch its kernel")
    stats = lw.lzhuf_walk.last_stats.tolist()
    plain_ms = None
    if want is None:
        want, plain_ms = timed(lambda: on_host(lw.lzhuf_walk_plain, *args))
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err:
        raise RuntimeError(f"lzhuf-walk kernel disagrees with plain: {err}")
    return got, err, ms, plain_ms, stats


def phase_lzhuf_walk_spec(t, want):
    """The token walk where its lane design can break, on the headline
    layout `t` (plain markers `want`): timed at 32 lanes of 32 phase
    walks, 64 of 16 and the default, each logging its lane boundaries
    resolved by a phase walk and by the slow route; then with one phase
    walk a lane, so that most lane boundaries take the slow route (the
    phase fails unless they do). Returns the largest difference, which
    must be 0."""
    from tpz_torch.kernels import lzhuf_walk as lw

    saved = lw.SPEC_LANES, lw.SPEC_PHASES
    args, hint = lw._walk_args(t), t["walk_end_bit"]
    err = 0
    by_lanes, stats_by_lanes = {}, {}
    try:
        for lw.SPEC_LANES, lw.SPEC_PHASES in ((32, 32), (64, 16), saved):
            key = f"{lw.SPEC_LANES}x{lw.SPEC_PHASES}"
            got, by_lanes[key] = timed(
                lambda: lw.lzhuf_walk(*args, walk_end_bit=hint), 5)
            stats_by_lanes[key] = lw.lzhuf_walk.last_stats.tolist()
            err = max(err, int((got.long() - want.long()).abs().max()))
        lw.SPEC_LANES, lw.SPEC_PHASES = saved[0], 1
        _, e, ms, _, stats = compare_lzhuf_walk(t, want)
        err = max(err, e)
    finally:
        lw.SPEC_LANES, lw.SPEC_PHASES = saved
    if err:
        raise RuntimeError(f"lzhuf-walk kernel disagrees with plain: {err}")
    log("lzhuf-kernels", input=f"16MiB-{LZHUF_METHOD}",
        walk_ms_by_lanes_x_phases=json.dumps(
            {k: round(v, 4) for k, v in by_lanes.items()}),
        walk_direct_slow_far_by_lanes_x_phases=json.dumps(stats_by_lanes))
    log("lzhuf-kernels", input=f"16MiB-{LZHUF_METHOD}-one-phase",
        walk_max_abs_err=e, walk_direct_slow_far=stats,
        walk_first_call_ms=f"{ms:.3f}")
    if stats[1] <= stats[0]:
        raise RuntimeError(f"one phase walk a lane: the slow route took "
                           f"only {stats[1]} of the lane boundaries: "
                           f"{stats}")
    return err


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
        if method == "lh5":
            # No codec path parses lazily; the kernel's lazy rule is held
            # here.
            (reach, _), e, _, _ = compare_parse_v1(inputs, window, lazy=True)
            err_p = max(err_p, e)
            log("lzhuf-kernels", input="1MiB-mixed-lh5-lazy",
                visited=int((reach > 0).sum()), parse_max_abs_err=err_p)
        t = lzhuf_walk_inputs(oracle.lzhuf_encode(small, _dict_bits(method),
                                                  lp.MAX_CHAIN),
                              len(small), method)
        markers, e, _, _, stats = compare_lzhuf_walk(t)
        err_w = max(err_w, e)
        err_r = max(err_r, compare_resolve(lw._dense_markers(markers, t), 1))
        log("lzhuf-kernels", input=f"1MiB-mixed-{method}",
            blocks=inputs[0].shape[0], segments=t["out_len"].shape[0],
            parse_max_abs_err=err_p, walk_max_abs_err=err_w,
            resolve_max_abs_err=err_r, walk_direct_slow_far=stats)

    inputs, window = lzhuf_parse_inputs(headline, LZHUF_METHOD)
    got, e, cold_ms, _ = compare_parse_v1(inputs, window)
    err_p = max(err_p, e)
    _, parse_ms = timed(lambda: parse.parse_extend_v1(
        *inputs, window, max_match=lp.MAX_MATCH), 5)
    _, parse_plain_ms = timed(lambda: parse.parse_extend_v1_plain(
        *inputs, window, max_match=lp.MAX_MATCH), 3)
    # The kernel writes reach and mlen. A match extends from a screen of at
    # most 8 bytes, 4 bytes a compare.
    parse_bound = bound([*inputs, *got], int((got[0] > 0).sum())
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
    markers, e, cold_ms, walk_plain_ms, stats = compare_lzhuf_walk(t)
    err_w = max(err_w, e)
    args = lw._walk_args(t)
    _, walk_ms = timed(lambda: lw.lzhuf_walk(
        *args, walk_end_bit=t["walk_end_bit"]), 5)
    err_r = max(err_r, compare_resolve(lw._dense_markers(markers, t), 1))
    # The function's own work: the serial walk's trips, whatever the
    # design (a lane's speculative tokens do not count).
    walk_bound = bound([*args, markers], walk_ops(
        markers, args[0].numel() + args[4].numel(), OPS_LZHUF_LITERAL,
        OPS_LZHUF_MATCH))
    log("lzhuf-kernels", input=f"16MiB-{LZHUF_METHOD}",
        segments=args[0].shape[0], walk_max_abs_err=err_w,
        resolve_max_abs_err=err_r, walk_ms=f"{walk_ms:.3f}",
        walk_first_call_ms=f"{cold_ms:.3f}",
        walk_plain_ms=f"{walk_plain_ms:.3f}",
        walk_bound_ms=f"{walk_bound['bound_ms']:.4f}",
        walk_lanes_x_phases=f"{lw.SPEC_LANES}x{lw.SPEC_PHASES}",
        walk_shared_bytes=lw.shared_bytes(args[0].shape[1]),
        walk_blocks_per_sm=lw.occupancy(args[0].shape[1]),
        walk_direct_slow_far=stats)
    err_w = max(err_w, phase_lzhuf_walk_spec(t, markers))
    return ({"max_abs_err": err_p, "ms": parse_ms,
             "plain_ms": parse_plain_ms, **parse_bound},
            {"max_abs_err": err_w, "ms": walk_ms, "plain_ms": walk_plain_ms,
             **walk_bound})


def lzhuf_pack_bound(tok, ml, md, table, plan, words) -> dict:
    """The LZHUF pack's bound: is_token, mlen, mdist, the rows' bytes (one
    a position; the halo around them is not read), the joint table, the
    header slots and the row offsets read once; the words written once."""
    tensors = [tok, ml, md, table, plan.head_vals, plan.head_bits,
               plan.head_off, plan.body_off, words]
    return bound_bytes_ops(tok.numel() + sum(t.numel() * t.element_size()
                                             for t in tensors), 0)


def phase_lzhuf_pack_kernel(headline):
    """Phase 9's last line: the LZHUF bit packer's kernel against the
    plain packer at the headline layout, lh5, on the inputs one headline
    lh5 encode's plan stage makes (caught from one encode call); the
    wrapper, the launch alone and the plain packer timed, the launch
    beside its bound."""
    from tpz_torch.kernels import lzhuf_pipeline as lp

    pack, launch = lp.pack_words, lp._pack_launch
    seen = []
    lp._pack_launch = lambda *a: seen.append(a) or launch(*a)
    try:
        lp.compress_many(headline, LZHUF_METHOD, "cuda")
    finally:
        lp._pack_launch = launch
    (blocks, window, tok, ml, md, table, plan, words), = seen
    args = (blocks, window, tok, ml, md, plan, words.numel())
    before = pack.launches
    got, cold_ms = timed(lambda: pack(*args))
    if pack.launches != before + 1:
        raise RuntimeError(f"LZHUF pack wrapper launched "
                           f"{pack.launches - before} times")
    want, plain_ms = timed(lambda: lp.pack_words_plain(*args))
    differ = int((got != want).sum())
    if differ:
        raise RuntimeError(f"LZHUF pack kernel disagrees with plain: {differ} "
                           f"of {want.numel()} words")
    del want
    _, ms = timed(lambda: pack(*args), 5)
    # The launch alone, again and again on the same words: each launch
    # stores or ORs the same bits, so the words stay as they were.
    words = got.clone()
    _, launch_ms = timed(lambda: launch(blocks, window, tok, ml, md, table,
                                        plan, words), 5)
    if not torch.equal(words, got):
        raise RuntimeError("LZHUF pack launches alone disagree with the "
                           "wrapper")
    b = lzhuf_pack_bound(tok, ml, md, table, plan, got)
    log("lzhuf-pack-kernel", method=LZHUF_METHOD, blocks=tok.shape[0],
        header_slots=plan.head_vals.shape[1], words=got.numel(),
        words_differ=0, wrapper_ms=f"{ms:.3f}",
        first_call_ms=f"{cold_ms:.3f}", launch_ms=f"{launch_ms:.3f}",
        plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b['bound_ms']:.4f}")
    return {"max_abs_err": 0, "ms": launch_ms, "plain_ms": plain_ms, **b}


def phase_lzhuf_slice(batch, small):
    """LZHUF encode and decode through the api on the card, against the
    oracle's bytes and the inputs. Returns the lh5 batch's blobs and its
    encode and decode counts."""
    from tpz_torch import api, oracle
    from tpz_torch.kernels import lzhuf_pipeline as lp
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
                           {"parse_v1": parse.parse_extend_v1,
                            "pack": lp.pack_words})
        bits = _dict_bits(method)
        for i, (d, blob) in enumerate(zip(datas, out)):
            if blob[15:] != oracle.lzhuf_encode(d, bits, 16):
                raise RuntimeError(f"{method} buffer {i}: body differs from "
                                   "the oracle's")
        # Each case is one group (at most MAX_DEVICE_SPAN bytes).
        if c["pack"] != 1:
            raise RuntimeError(f"encode-{method}: the pack kernel launched "
                               f"{c['pack']} times (want 1)")
        blobs[method] = out
        counts[method] = c
        log("lzhuf-slice", path=f"encode-{method}", buffers=len(datas),
            bytes=sum(len(d) for d in datas),
            ratio=f"{sum(map(len, out)) / sum(map(len, datas)):.4f}",
            cold_s=f"{dt:.3f}", parse_v1_launches=c["parse_v1"],
            pack_launches=c["pack"], oracle_identical=True)
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
    # LZHUF has no checksum: a flip in the tables' header raises, one in
    # the body decodes to other bytes, on the card as on the CPU.
    blob = api.compress(corrupt_data(), LZHUF_METHOD, device="cuda")
    outcomes = {where: same_outcome(f"corrupt {LZHUF_METHOD}",
                                    corrupt(blob, where), LZHUF_METHOD)
                for where in (40, 0.5)}
    if outcomes[40] == "bytes" or outcomes[0.5] != "bytes":
        raise RuntimeError(f"corrupt {LZHUF_METHOD}: {outcomes}")
    log("lzhuf-slice", path=f"corrupt-{LZHUF_METHOD}",
        same_as_cpu=json.dumps({str(k): v for k, v in outcomes.items()}))
    return blobs[LZHUF_METHOD], counts[LZHUF_METHOD]


# Host time between each end of a traced session's step and the traced
# call (traced_session says why).
TRACE_MARGIN_S = 0.05


def names_kernel(event_name: str, kernel: str) -> bool:
    """Whether a trace's kernel event names the CUDA kernel `kernel` (the
    trace gives a C++ kernel its namespace, template arguments and
    signature)."""
    return (event_name == kernel or f"{kernel}(" in event_name
            or f"{kernel}<" in event_name)


def missing_kernels(events, counters, t0_us: float, t1_us: float) -> list:
    """The CUDA kernels (each wrapper's .kernels) of the wrappers in
    `counters` that launched, which no kernel event that the host launched
    in [t0_us, t1_us] names."""
    names = [e.name for e in traceops.launched(events, t0_us, t1_us)
             if e.cat == "kernel"]
    return [k for c in counters.values() if c.launches
            for k in c.kernels
            if not any(names_kernel(n, k) for n in names)]


def traced_session(fn, label: str, counters: dict,
                   margin_s: float = None):
    """One torch.profiler session of fn: a warm-up step (tracing on, its
    records dropped), then a traced step that calls fn until margin_s
    (TRACE_MARGIN_S by default) has passed, then fn once more under a
    `label` annotation, then margin_s of idle host time. The profiler
    keeps only the device events that its clock places inside the traced
    step, and that clock stands off the host's by an offset that changes
    from session to session (trace_offset.py measures it); without the
    margins, traces lost a call's first kernels (phase 14's
    bzip2_records_kernel twice, greedy_parse's reach_tile_walk once). The
    calls before the annotation keep the traced call as warm as the one
    before it. The wrappers' counts are set to 0 just before the traced
    call. Returns (the session's events, benchmark/traceops.py's, the
    traced call's wall ms, the annotation's [t0_us, t1_us])."""
    from torch.profiler import ProfilerActivity, profile, schedule

    margin_s = TRACE_MARGIN_S if margin_s is None else margin_s
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        start = time.perf_counter()
        while time.perf_counter() - start < margin_s:
            fn()
            torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        with torch.profiler.record_function(label):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(margin_s)
        prof.step()
    events = traceops.from_profiler(prof, labels=(label,))
    return events, wall_ms, traceops.span_of(events, label)


def profile_call(fn, label: str, counters: dict,
                 phase: str = "lzhuf-profile") -> None:
    """One call of fn in a traced_session: logs its wall time, the busy
    time of the device events it launched (tied to it by correlation id,
    since the trace places a session's device events against the host's
    clock with an offset of its own), idle share, the device time of each
    CUDA kernel of the wrappers in `counters` (name -> wrapper) and the
    top device ops. Raises if the trace holds no device time, or lacks a
    kernel of a wrapper that the call launched."""
    events, wall_ms, window = traced_session(fn, label, counters)
    launched = traceops.launched(events, *window)
    busy_ms = traceops.busy_us(launched) / 1e3
    if busy_ms <= 0:
        raise RuntimeError(f"{label}: the trace holds no device time")
    counts = {name: c.launches for name, c in counters.items()}
    if min(counts.values()) < 1:
        raise RuntimeError(f"{label}: a wrapper did not launch: {counts}")
    missing = missing_kernels(events, counters, *window)
    if missing:
        names = sorted({e.name[:60] for e in events if e.cat == "kernel"})
        raise RuntimeError(f"{label}: launched kernels missing from the "
                           f"trace: {missing}; the trace's {len(names)} "
                           f"kernel names: {names}")
    per_kernel = {k: round(sum(e.dur for e in launched
                               if names_kernel(e.name, k)) / 1e3, 3)
                  for c in counters.values() for k in c.kernels}
    top = traceops.top_ops(launched, 8)
    log(phase, call=label, wall_ms=f"{wall_ms:.2f}",
        busy_ms=f"{busy_ms:.2f}", idle_share=f"{1 - busy_ms / wall_ms:.4f}",
        launches=counts, kernels_in_trace=True,
        kernel_ms=json.dumps(per_kernel),
        top=json.dumps({n[:60]: round(sec * 1e3, 3) for n, sec in top}))


def phase_lzhuf_profile(batch, blobs) -> None:
    from tpz_torch import api
    from tpz_torch.kernels import lzhuf_pipeline as lp
    from tpz_torch.kernels import lzhuf_walk as lw
    from tpz_torch.kernels import parse
    from tpz_torch.kernels import resolve_walk as rw

    profile_call(lambda: api.compress_many(batch, LZHUF_METHOD,
                                           device="cuda"),
                 f"{LZHUF_METHOD}-encode", {"parse_v1": parse.parse_extend_v1,
                                            "pack": lp.pack_words})
    profile_call(lambda: api.decompress_many(blobs, LZHUF_METHOD,
                                             device="cuda"),
                 f"{LZHUF_METHOD}-decode",
                 {"walk": lw.lzhuf_walk, "resolve": rw.resolve_copy_machine})


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
    """bzip2 symbol-walk kernels vs plain on the same CUDA tensors (the
    plain walk on host copies of them), the kernels at the default MTF^-1
    segment length (bzip2_walk.REC_SEG) and at MTF_SEG_CHECK: (recs, meta,
    max abs difference, kernel ms, plain ms), each timed on its first
    call. Raises unless records and meta are equal."""
    from tpz_torch.kernels import bzip2_walk as bw

    args = [t[k] for k in bw.WALK_ARGS]
    before = bw.bzip2_walk.launches
    (recs, meta), ms = timed(lambda: bw.bzip2_walk(*args, S))
    recs32, meta32 = bw.bzip2_walk(*args, S, mtf_seg=MTF_SEG_CHECK)
    if bw.bzip2_walk.launches != before + 2:
        raise RuntimeError("bzip2 walk wrapper did not launch its kernels")
    (precs, pmeta), plain_ms = timed(
        lambda: on_host(bw.bzip2_walk_plain, *args, S))
    err = max(int((r.long() - precs.long()).abs().max()
                  + (m.long() - pmeta.long()).abs().max())
              for r, m in ((recs, meta), (recs32, meta32)))
    if err:
        raise RuntimeError(f"bzip2-walk kernels disagree with plain: {err}")
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


def bzip2_symbols(recs, meta):
    """([NB] symbols each block's walk consumed, [NB] of them run
    symbols): a literal is one symbol, a run record of count c its
    floor(log2(c + 1)) RUNA/RUNB digits (count 1 is one symbol either way,
    counted a literal), a block that ends well its end-of-block."""
    live = torch.arange(recs.shape[1], device=recs.device)[None, :] \
        < meta[:, :1]
    cnt = torch.where(live, recs.long() >> 8, 0)
    # floor(log2(c + 1)) in integers: a float log2 on the card can round
    # an exact power of two down.
    digits = sum(((cnt + 1) >> k) > 0 for k in range(1, 32)).long()
    runs = torch.where(cnt >= 2, digits, 0).sum(1)
    return digits.sum(1) + (meta[:, 1] == 0).long(), runs


def bzip2_walk_ops(recs, meta, mtf_init, n_used) -> int:
    """#6's operations on this run's records (count << 8 | byte): a
    Huffman step per symbol, an add per run symbol, and per record the
    MTF^-1's read, front write and store, and its rank's list entries
    moved. The ranks come back from the bytes by the plain MTF encode, each
    byte relabelled by its place in the block's list of used bytes (the
    first n_used of mtf_init), so that the encode starts from the identity
    list: a run record's byte is the list head, rank 0."""
    from tpz_torch.kernels import mtf

    symbols, runs = bzip2_symbols(recs, meta)
    nrec = meta[:, 0].to(torch.int32)
    pos = torch.arange(256, device=recs.device).expand(recs.shape[0], 256)
    used = torch.where(pos < n_used.long()[:, None], mtf_init.long(), 256)
    place = torch.zeros((recs.shape[0], 257), dtype=torch.int64,
                        device=recs.device).scatter_(1, used, pos)
    ranks = mtf.mtf_ranks_plain(place.gather(1, recs.long() & 255).int(),
                                nrec)
    return (int(symbols.sum()) * OPS_HUFFMAN_SYMBOL
            + int(runs.sum()) * OPS_RLE2_RUN
            + int(nrec.sum()) * OPS_MTF_INVERSE
            + int(ranks.sum()) * OPS_MTF_MOVE)


def phase_bzip2_kernels(small, long_blobs, blobs):
    """#6 and #7 against their plain versions on the small streams, a
    periodic block and (the iBWT) the headline batch, #6 also on the long
    blocks of `long_blobs` (the plain walk on the host); both timed at the
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
            mtf_segs=[bw.REC_SEG, MTF_SEG_CHECK], walk_max_abs_err=err_w,
            plain_ms=f"{plain_ms:.1f}", **kv)
    # Long blocks: every records pass wraps its ring several times, and
    # the corrupted block's error falls after it has.
    t, N, S = bzip2_layout(list(long_blobs.values()))
    recs, meta, e, _, long_plain_ms = compare_bzip2_walk(t, S)
    err_w = max(err_w, e)
    symbols, _ = bzip2_symbols(recs, meta)
    errs = (meta[:, 1] & 1023).tolist()
    if (int(symbols.min()) < 3 * BZIP2_RING or any(errs[:-1])
            or not errs[-1]):
        raise RuntimeError(f"long blocks: symbols {symbols.tolist()}, err "
                           f"{errs}; want >= 3 rings each, the last in error")
    log("bzip2-kernels", input=list(long_blobs), N=N, S=S,
        symbols=symbols.tolist(), records=meta[:, 0].tolist(), err=errs,
        ring=BZIP2_RING, mtf_segs=[bw.REC_SEG, MTF_SEG_CHECK],
        walk_max_abs_err=err_w, plain_ms=f"{long_plain_ms:.1f}")
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
    walk_bound = bound_bytes_ops(walk_bytes, bzip2_walk_ops(
        recs, meta, t["mtf_init"], t["n_used"]))
    log("bzip2-kernels", input="headline-2x16MiB-l9", blocks=len(nrec),
        N=N, S=S, records=int(nrec.sum()), records_max=int(nrec.max()),
        walk_ms=f"{walk_ms:.3f}",
        walk_first_call_ms=f"{cold_ms:.3f}",
        walk_plain_ms=f"{walk_plain_ms:.3f}",
        walk_plain_shape=walk_plain_at,
        walk_bound_ms=f"{walk_bound['bound_ms']:.4f}",
        walk_bound_by=walk_bound["bound_by"], rec_seg=bw.REC_SEG)

    args = ibwt_inputs(t, recs, meta, N)
    del recs, t
    seg = iw.IBWT_SEG
    out, flag, e, cold_ms, ibwt_plain_ms = compare_ibwt(args, seg)
    err_i = max(err_i, e)
    if int(flag.sum()):
        raise RuntimeError(f"headline blocks flagged: {flag.tolist()}")
    _, ibwt_ms = timed(lambda: iw.ibwt(*args, seg), 5)
    n = int(args[2].long().sum())
    # The function's own work: w read once, a byte out and a step a node,
    # and the start, length and flag of each block; the design's chains,
    # staging and stitch do not count.
    ibwt_bound = bound_bytes_ops(n * 5 + 8 * flag.numel(),
                                 n * OPS_IBWT_STEP)
    log("bzip2-kernels", input="headline-2x16MiB-l9", nodes=n,
        seg=seg, ibwt_max_abs_err=err_i,
        ibwt_first_call_ms=f"{cold_ms:.3f}",
        ibwt_plain_ms=f"{ibwt_plain_ms:.3f}", ibwt_ms=f"{ibwt_ms:.3f}",
        ibwt_bound_ms=f"{ibwt_bound['bound_ms']:.4f}",
        ibwt_walk_resident=iw.walk_resident())
    # The candidate strides: the same bytes and flags, each timed.
    by_seg = {}
    for other in IBWT_STRIDES:
        got, ms = timed(lambda: iw.ibwt(*args, other), 5)
        if not (torch.equal(got[0], out) and torch.equal(got[1], flag)):
            raise RuntimeError(f"ibwt at seg {other} differs from seg {seg}")
        by_seg[other] = round(ms, 4)
    log("bzip2-kernels", input="headline-2x16MiB-l9",
        ibwt_ms_by_seg=json.dumps(by_seg))
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


def phase_bzip2_profile(blobs) -> None:
    """One bzip2 decode call of the headline blobs under torch.profiler, as
    phase 11: the time of each of the walk's kernels and the iBWT's."""
    from tpz_torch import api
    from tpz_torch.kernels import bzip2_walk as bw
    from tpz_torch.kernels import ibwt_walk as iw

    profile_call(lambda: api.decompress_many(blobs, "bzip2", device="cuda"),
                 "bzip2-decode", {"walk": bw.bzip2_walk, "ibwt": iw.ibwt},
                 phase="bzip2-profile")


def bzip2_inputs(batch):
    """The bzip2 phases' streams: the headline batch at oracle level 9, a
    16 MiB stdlib level-9 stream, a two-stream concatenation (stdlib level
    1 then oracle level 9), the small streams of phase 12 (about 5,000
    symbols a block: the plain walk takes one trip per symbol, about 2 ms
    each on the card), one with zeroed symbol bits, and its long level-1
    blocks, the last with symbol bits zeroed three quarters in."""
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
    mixed = oracle.bzip2_encode(corpus.mixed(LONG_BLOCK_BYTES, seed=41), 1)
    corrupt = bytearray(mixed)
    at = len(corrupt) * 3 // 4
    corrupt[at:at + 100] = bytes(100)
    long_blobs = {
        "stdlib-l1-text-64KiB": bz2.compress(
            corpus.text(LONG_BLOCK_BYTES, seed=42), 1),
        "oracle-l1-mixed-64KiB": mixed,
        "corrupt-oracle-l1-mixed-64KiB": bytes(corrupt)}
    return blobs, stdlib, cat, small, long_blobs


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


def compare_mtf(v, n, alpha, segs=()):
    """MTF kernels vs plain on the same CUDA tensors, the kernels at the
    default segment length and at each of `segs`: (max abs difference,
    kernel ms, plain ms), each timed on its first call. Raises unless the
    ranks are equal."""
    from tpz_torch.kernels import mtf

    before = mtf.mtf_ranks.launches
    got, ms = timed(lambda: mtf.mtf_ranks(v, n, alpha))
    others = [mtf.mtf_ranks(v, n, alpha, seg) for seg in segs]
    if mtf.mtf_ranks.launches != before + 1 + len(segs):
        raise RuntimeError("mtf wrapper did not launch its kernels")
    want, plain_ms = timed(lambda: mtf.mtf_ranks_plain(v, n, alpha))
    err = max(int((g - want).abs().max()) for g in [got, *others])
    if err:
        raise RuntimeError(f"mtf kernels disagree with plain: {err}")
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
        e1, _, _ = compare_mtf(v, n, 256, (MTF_SEG_CHECK,))
        e2, _, _ = compare_mtf(sel, nsel, 6, (MTF_SEG_CHECK,))
        err = max(err, e1, e2)
        log("bzip2-encode-kernels", input=name, symbols=int(n.sum()),
            selectors=int(nsel.sum()), segs=[mtf.MTF_SEG, MTF_SEG_CHECK],
            max_abs_err=err)
    (v, n), (sel, nsel), rounds = bzip2_encode_front(batch)
    e, cold_ms, plain_ms = compare_mtf(v, n, 256)
    ranks, ms = timed(lambda: mtf.mtf_ranks(v, n), 5)
    es, sel_cold_ms, sel_plain_ms = compare_mtf(sel, nsel, 6)
    _, sel_ms = timed(lambda: mtf.mtf_ranks(sel, nsel, 6), 5)
    err = max(err, e, es)
    symbols = int(n.long().sum())
    # The walk reads each live symbol and writes its rank; each symbol
    # moves as many list entries as its rank.
    mtf_bound = bound_bytes_ops(
        8 * symbols + 4 * n.numel(),
        symbols * OPS_MTF_ENCODE + int(ranks.long().sum()) * OPS_MTF_MOVE)
    log("bzip2-encode-kernels", input="headline-2x16MiB-l9",
        blocks=n.numel(), N=v.shape[1], bwt_rounds=rounds, symbols=symbols,
        max_abs_err=err, ms=f"{ms:.3f}", first_call_ms=f"{cold_ms:.3f}",
        plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{mtf_bound['bound_ms']:.4f}",
        bound_by=mtf_bound["bound_by"], seg=mtf.MTF_SEG,
        selectors=int(nsel.long().sum()), sel_ms=f"{sel_ms:.3f}",
        sel_first_call_ms=f"{sel_cold_ms:.3f}",
        sel_plain_ms=f"{sel_plain_ms:.3f}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **mtf_bound}


def phase_bzip2_encode_slice(batch, blobs):
    """bzip2 encode through the api on the card: the headline batch at
    level 9 equals the oracle's blobs of phase 12 and round-trips through
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


def phase_bzip2_encode_profile(batch) -> None:
    """One bzip2 level-9 encode call of the headline batch under
    torch.profiler, as phase 11: the MTF's kernels."""
    from tpz_torch import api
    from tpz_torch.kernels import mtf

    profile_call(lambda: api.compress_many(batch, "bzip2", BZIP2_LEVEL,
                                           device="cuda"),
                 "bzip2-encode", {"mtf": mtf.mtf_ranks},
                 phase="bzip2-encode-profile")


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


def reach_rows():
    """Synthetic step rows for the reach walk, by name: [NB, N] int32 on
    the card, made from a numpy seed."""
    rng = np.random.default_rng(19)
    n = 1 << 16
    never = np.full((2, n), 2)
    never[:, 0] = 1  # odd true walk; every tile's guess is even
    never[1, n // 2:] = rng.integers(1, 9, size=n // 2)
    skip = rng.integers(1, 9, size=(4, n))
    skip[0, 0] = 40000                  # past the first tiles of any size
    skip[1, ::5003] = 17000             # past a 16,384 tile, repeatedly
    skip[2, 10] = 65500                 # fits 16 bits, to the last tile
    skip[3, 7::4099] = 65536            # would wrap a 16-bit code to 0
    skip[3, 60001::7] = 70000
    ends = rng.integers(-5, 4, size=(3, n))
    ends[1, 1000] = n
    ends[2, 2000] = 2**31 - 1
    rows = {"never_meeting": never, "skipping": skip, "below_1_and_past_n":
            ends, "n_65632": rng.integers(1, 259, size=(3, n + 96)),
            "one_row": rng.integers(1, 259, size=(1, n))}
    return {k: torch.from_numpy(v.astype(np.int32)).cuda()
            for k, v in rows.items()}


def compare_reach(step, want):
    """reach_walk vs the doubling's mask `want` on the card: max abs
    difference, which must be 0."""
    from tpz_torch.kernels import parse

    err = int((parse.reach_walk(step) - want).abs().max())
    if err:
        raise RuntimeError(f"reach kernels disagree with plain at "
                           f"REACH_TILE={parse.REACH_TILE}: {err}")
    return err


def phase_parse_kernels_8_9(headline, small):
    """#8 and #9 through their public functions (no codec path reaches
    either, as in the reference): greedy_parse on the headline gzip
    parse's lengths, whose token set it must give back, and #8 against
    its doubling, there and on reach_rows() at each tile of REACH_TILES
    (timed at each), and one greedy_parse call profiled; parse_extend_v3w
    against its plain version on the 1 MiB inputs (greedy and lazy) and at
    the headline, and against #1 at n_extend=1 at live positions. Returns
    the kernel-line rows and launches of #8 and #9."""
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
        reach_tile=parse.REACH_TILE, reach_ms=f"{reach_ms:.3f}",
        reach_plain_ms=f"{reach_plain_ms:.3f}",
        reach_bound_ms=f"{reach_bound['bound_ms']:.4f}")

    # The tiles: each synthetic row and the headline at every tile length,
    # the headline timed there (5 warm calls each).
    default = parse.REACH_TILE
    rows = reach_rows()
    wants = {k: parse._reach_doubling(torch.clamp(v.long(), min=1)).int()
             for k, v in rows.items()}
    tile_ms = {}
    try:
        for tile in REACH_TILES:
            parse.REACH_TILE = tile
            for name, v in rows.items():
                err8 = max(err8, compare_reach(v, wants[name]))
            err8 = max(err8, compare_reach(step, want8))
            _, tile_ms[tile] = timed(lambda: parse.reach_walk(step), 5)
    finally:
        parse.REACH_TILE = default
    log("parse-kernels-8-9", reach_rows=json.dumps(
        {k: list(v.shape) for k, v in rows.items()}),
        reach_rows_max_abs_err=err8,
        reach_ms_by_tile=json.dumps({t: round(ms, 4)
                                     for t, ms in tile_ms.items()}),
        fastest_tile=min(tile_ms, key=tile_ms.get))
    del rows, wants
    profile_call(lambda: parse.greedy_parse(mlen, mdist, bl), "greedy_parse",
                 {"reach": parse.reach_walk}, phase="parse-kernels-8-9")
    return ({"max_abs_err": err8, "ms": reach_ms, "plain_ms": reach_plain_ms,
             **reach_bound}, c8["reach"],
            {"max_abs_err": err9, "ms": v3w_ms, "plain_ms": v3w_plain_ms,
             **v3w_bound}, c9["v3w"])


def stream_encode(fmt, data, run, flush_every=0):
    """data through a CodecStream on the card in writes of `run` bytes:
    Action.FLUSH after every `flush_every` bytes (0: never), FINISH with
    the last write, RUN otherwise. Returns the stream's bytes."""
    from tpz_torch import api
    from tpz_torch.action import Action

    s = api.CodecStream(fmt, LEVEL, device="cuda")
    out = []
    for i in range(0, len(data), run):
        end = min(i + run, len(data))
        if end == len(data):
            action = Action.FINISH
        elif flush_every and end % flush_every == 0:
            action = Action.FLUSH
        else:
            action = Action.RUN
        out.append(s.drive(data[i:end], action))
    return b"".join(out)


def stream_expected(fmt, data, flush_every):
    """The oracle's bytes of a stream flushed every `flush_every` bytes:
    the header once, a sync-flushed segment a flush, the last segment's
    final blocks, the trailer over all the data."""
    from tpz_torch import oracle
    from tpz_torch.codecs import gzip_codec, zlib_codec
    from tpz_torch.codecs.deflate import DeflateConfig

    params = DeflateConfig(LEVEL).params_array()
    cuts = list(range(flush_every, len(data), flush_every))
    segs = [data[a:b] for a, b in zip([0, *cuts], cuts)]
    body = b"".join(oracle.deflate_encode_flush(seg, params) for seg in segs)
    body += oracle.deflate_encode(data[cuts[-1] if cuts else 0:], params)
    if fmt == "gzip":
        return gzip_codec.header_bytes(LEVEL) + body + gzip_codec._trailer(
            data)
    if fmt == "zlib":
        return zlib_codec.header_bytes(LEVEL) + body + struct.pack(
            ">I", zlib.adler32(data))
    return body


def check_unflushed(fmt, data, blob):
    """A stream finished without a flush is api.compress's bytes on the
    card, whose body is the oracle's."""
    from tpz_torch import api, oracle
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig

    if blob != api.compress(data, fmt, LEVEL, device="cuda"):
        raise RuntimeError(f"stream-encode {fmt}: differs from api.compress")
    body = {"gzip": lambda b: b[gzip_codec.parse_header_extra(b, 0)[0]:-8],
            "zlib": lambda b: b[2:-4], "deflate": lambda b: b}[fmt](blob)
    params = DeflateConfig(LEVEL).params_array()
    if body != oracle.deflate_encode(data, params):
        raise RuntimeError(f"stream-encode {fmt}: body differs from oracle")


def phase_stream_encode(data, smi) -> None:
    """CodecStream on the card: gzip at 16 MiB in 1 MiB writes, unflushed
    and flushed every 4 MiB; zlib and deflate the same at 1 MiB; each
    finish() launches #1 once. A bzip2 flush gives two streams, an lh5
    flush raises."""
    from tpz_torch import api
    from tpz_torch.errors import DataError
    from tpz_torch.kernels import parse

    plain = {"gzip": gzip.decompress, "zlib": zlib.decompress,
             "deflate": lambda b: zlib.decompress(b, -15)}
    for fmt, d, run, every in (("gzip", data, STREAM_RUN, STREAM_FLUSH),
                               ("zlib", data[:MIB], MIB // 4, MIB // 2),
                               ("deflate", data[:MIB], MIB // 4, MIB // 2)):
        for flush in (0, every):
            blob, dt, c = drive("stream-encode", f"{fmt}-flush-{flush}",
                                lambda: stream_encode(fmt, d, run, flush),
                                {"parse": parse.parse_extend_v3})
            if c["parse"] != 1:
                raise RuntimeError(f"stream-encode {fmt}: #1 launched "
                                   f"{c['parse']} times, not once")
            if flush:
                if blob != stream_expected(fmt, d, flush):
                    raise RuntimeError(f"stream-encode {fmt}: flushed "
                                       "stream differs from the oracle's")
            else:
                check_unflushed(fmt, d, blob)
            if plain[fmt](blob) != d:
                raise RuntimeError(f"stream-encode {fmt}: stdlib round "
                                   "trip failed")
            log("stream-encode", format=fmt, bytes=len(d), run=run,
                flush_every=flush, out_bytes=len(blob),
                parse_launches=c["parse"], cold_s=f"{dt:.3f}",
                oracle_identical=True)
    for flush in (0, STREAM_FLUSH):
        median, times = warm_median(lambda _: stream_encode(
            "gzip", data, STREAM_RUN, flush), range(TIMING_ITERS))
        log("stream-encode", format="gzip", flush_every=flush,
            mb_per_s=f"{len(data) / median / 1e6:.2f}",
            median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
            card=f"'{smi}'")
    half = data[:MIB // 2]
    s = api.CodecStream("bzip2", BZIP2_LEVEL, device="cuda")
    s.write(half)
    first = s.flush()
    s.write(data[MIB // 2:MIB])
    blob = first + s.finish()
    if (bz2.decompress(first) != half or bz2.decompress(blob) != data[:MIB]
            or blob[len(first):len(first) + 3] != b"BZh"):
        raise RuntimeError("stream-encode bzip2: flushed stream is not two "
                           "streams that bz2 reads")
    s = api.CodecStream("lh5", device="cuda")
    s.write(half)
    try:
        s.flush()
    except DataError as e:
        lh5 = f"'DataError: {e}'"
    else:
        raise RuntimeError("stream-encode lh5: flush did not raise")
    log("stream-encode", format="bzip2", streams=2, bz2_reads=True,
        lh5_flush=lh5)


def decode_stream(fmt, blob):
    from tpz_torch import api

    s = api.DecodeStream(fmt)
    out = [s.write(blob[i:i + STREAM_PIECE])
           for i in range(0, len(blob), STREAM_PIECE)]
    out.append(s.finish())
    return b"".join(out)


def phase_stream_decode(cases, smi) -> None:
    """DecodeStream (on the host, as the reference's) on each blob in
    64 KiB writes; a truncated blob raises UnexpectedEof."""
    from tpz_torch.errors import UnexpectedEof

    for name, fmt, blob, want in cases:
        t0 = time.perf_counter()
        got = decode_stream(fmt, blob)
        dt = time.perf_counter() - t0
        if got != want:
            raise RuntimeError(f"stream-decode {name}: output differs")
        try:
            decode_stream(fmt, blob[:len(blob) // 2])
        except UnexpectedEof as e:
            truncated = f"'UnexpectedEof: {e}'"
        else:
            raise RuntimeError(f"stream-decode {name}: truncated blob "
                               "decoded")
        log("stream-decode", input=name, format=fmt, bytes=len(want),
            piece=STREAM_PIECE, mb_per_s=f"{len(want) / dt / 1e6:.2f}",
            seconds=f"{dt:.4f}", truncated=truncated, route="host",
            card=f"'{smi}'")


def phase_lzss(data) -> None:
    """formats(), and 16 MiB of raw LZSS through the api on "cuda" (the
    codec runs on the host, as the reference's does)."""
    from tpz_torch import api, oracle
    from tpz_torch.codecs.lzss import LzssConfig

    want = ["bgzf", "bzip2", "deflate", "gzip", "lh4", "lh5", "lh6", "lh7",
            "lzss", "zlib"]
    if api.formats() != want:
        raise RuntimeError(f"formats() is {api.formats()}")
    t0 = time.perf_counter()
    blob = api.compress(data, "lzss", device="cuda")
    t1 = time.perf_counter()
    back = api.decompress(blob, "lzss", device="cuda")
    t2 = time.perf_counter()
    ref = len(data).to_bytes(8, "little") + oracle.lzss_pack(
        oracle.lzss_tokenize(data, LzssConfig().params_array()))
    if blob != ref or back != data:
        raise RuntimeError("lzss: bytes differ from the oracle's or the "
                           "round trip failed")
    log("lzss", formats=",".join(api.formats()), bytes=len(data),
        ratio=f"{len(blob) / len(data):.4f}",
        encode_mb_per_s=f"{len(data) / (t1 - t0) / 1e6:.2f}",
        decode_mb_per_s=f"{len(data) / (t2 - t1) / 1e6:.2f}", route="host",
        oracle_identical=True)


def compare_crc(t, variant, chunk=None):
    """crc32_lanes against its plain version on the same CUDA tensor:
    (max abs difference of the chunk registers and the combined one, which
    must be 0; the kernel's result)."""
    from tpz_torch.kernels import checksums as ck

    kw = {} if chunk is None else {"chunk": chunk}
    before = ck.crc32_lanes.launches
    regs, reg = ck.crc32_lanes(t, variant, **kw)
    if ck.crc32_lanes.launches != before + 1:
        raise RuntimeError("crc32 lanes wrapper did not launch its kernel")
    pregs, preg = ck.crc32_lanes_plain(t, variant, **kw)
    err = max(int((regs - pregs).abs().max()) if regs.numel() else 0,
              int((reg - preg).abs()))
    if err:
        raise RuntimeError(f"crc32 lanes kernel disagrees with plain "
                           f"({variant}, chunk {chunk}): {err}")
    return err, (regs, reg)


def crc_chunk_pass_ms(t, chunk, reps=20):
    """The chunk pass of crc32_lanes alone (its C entry launched `reps`
    times on prepared buffers, no fold, no wrapper): ms a launch."""
    from tpz_torch.kernels import _build
    from tpz_torch.kernels import checksums as ck

    L = -(-t.numel() // chunk)
    tab, _ = ck._device_tables("reflected", chunk, ck._n_levels(L),
                               str(t.device))
    regs = torch.empty(L, dtype=torch.int64, device=t.device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.lib()

    def run():
        for _ in range(reps):
            rc = lib.tpz_crc32_lanes(t.data_ptr(), t.numel(), chunk, 0,
                                     tab.data_ptr(), regs.data_ptr(), None,
                                     0, None, None, 0, stream)
            if rc:
                raise RuntimeError(f"crc32_chunks launch failed: {rc}")

    run()
    return timed(run)[1] / reps


def phase_checksums(small, data, smi):
    """The CRC lane kernel against its plain version, exactly; crc32,
    adler32 and crc32_combine against zlib and the oracle; the kernel's
    main-path launch (crc32 of 16 MiB on the card) and its times."""
    from tpz_torch import oracle
    from tpz_torch.kernels import checksums as ck

    big = data + data[:5]
    dev = torch.frombuffer(bytearray(big), dtype=torch.uint8).cuda()
    cases = {"mixed-1MiB": small["mixed"],
             "repetitive-1MiB": small["repetitive"]}
    worst = 0
    for name, d in cases.items():
        t = torch.frombuffer(bytearray(d), dtype=torch.uint8).cuda()
        for variant in ck.VARIANTS:
            err, _ = compare_crc(t, variant)
            worst = max(worst, err)
    for n in (1, 3, 4097, len(big)):
        for variant in ck.VARIANTS:
            err, _ = compare_crc(dev[:n], variant)
            worst = max(worst, err)
    # A view that starts off a 16-byte boundary, and other chunk lengths.
    for chunk in CRC_CHUNKS:
        err, _ = compare_crc(dev[3:3 + MIB], "reflected", chunk)
        worst = max(worst, err)
    log("checksums", cases="mixed-1MiB,repetitive-1MiB,1,3,4097,16MiB+5,"
        "offset-3", variants=",".join(ck.VARIANTS), chunks=CRC_CHUNKS,
        max_abs_err=worst)
    a, b = small["mixed"], data[:4097]
    checks = {
        "crc32-reflected": (ck.crc32(data, "reflected", device="cuda"),
                            zlib.crc32(data)),
        "crc32-msb": (ck.crc32(data, "msb", device="cuda"),
                      oracle.crc32_msb(data) ^ 0xFFFFFFFF),
        "adler32": (ck.adler32(data, device="cuda"), zlib.adler32(data)),
        "crc32-combine": (ck.crc32_combine(
            ck.crc32(a, device="cuda"), ck.crc32(b, device="cuda"), len(b)),
            zlib.crc32(a + b)),
    }
    for name, (got, want) in checks.items():
        if got != want:
            raise RuntimeError(f"checksums {name}: {got:#x} != {want:#x}")
    # The main path: crc32 of 16 MiB on the card, counted alone.
    _, _, c = drive("checksums", "crc32-16MiB", lambda: ck.crc32(
        data, "reflected", device="cuda"), {"crc": ck.crc32_lanes})
    launches = c["crc"]
    t = dev[:len(data)]
    ck.crc32_lanes(t, "reflected")
    times, alone = {}, {}
    for chunk in CRC_CHUNKS:
        ck.crc32_lanes(t, "reflected", chunk)  # host tables, warm
        _, times[chunk] = timed(lambda: ck.crc32_lanes(t, "reflected",
                                                        chunk), 5)
        alone[chunk] = crc_chunk_pass_ms(t, chunk)
    ms = times[ck.CRC_CHUNK]
    _, plain_ms = timed(lambda: ck.crc32_lanes_plain(t, "reflected"))
    b = bound_bytes_ops(len(data), len(data) * OPS_CRC_BYTE)
    log("checksums", bytes=len(data), launches=launches,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        bound_ms=f"{b['bound_ms']:.4f}", bound_by=b["bound_by"],
        ms_by_chunk={k: round(v, 4) for k, v in times.items()},
        chunk_pass_ms_by_chunk={k: round(v, 4) for k, v in alone.items()},
        oracle_identical=True, card=f"'{smi}'")
    return launches, {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                      **b}


def phase_cli() -> None:
    """python -m tpz_torch as a subprocess on the card: selftest of every
    format at 1 MiB, then compress / decompress file round trips."""
    from tpz_torch import REPO_ROOT, api
    from tpz_torch.utils import corpus

    env = dict(os.environ, PYTHONPATH=REPO_ROOT)

    def run(*args):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "tpz_torch", *args],
                           capture_output=True, text=True, cwd=REPO_ROOT,
                           env=env, timeout=600)
        if r.returncode:
            raise RuntimeError(f"cli {args}: exit {r.returncode}\n"
                               f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
        return r, time.perf_counter() - t0

    r, dt = run("selftest", "-n", str(MIB), "--device", "cuda")
    lines = r.stdout.strip().splitlines()
    if ([ln.split()[0] for ln in lines] != api.formats()
            or any(ln.split()[1] != "OK" for ln in lines)):
        raise RuntimeError(f"cli selftest:\n{r.stdout}")
    log("cli", cmd="selftest", bytes=MIB, formats=len(lines), all_ok=True,
        seconds=f"{dt:.1f}")
    build = os.path.join(REPO_ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        src = os.path.join(tmp, "doc.txt")
        data = corpus.text(MIB, seed=61)
        for fmt, suffix in (("gzip", ".gz"), ("lh5", ".lh5")):
            with open(src, "wb") as f:
                f.write(data)
            _, enc_s = run("compress", src, "-f", fmt, "--device", "cuda")
            os.remove(src)
            r, dec_s = run("decompress", src + suffix, "-f", fmt,
                           "--device", "cuda")
            with open(src, "rb") as f:
                if f.read() != data:
                    raise RuntimeError(f"cli {fmt}: round trip failed")
            log("cli", cmd="compress+decompress", format=fmt, bytes=MIB,
                stats=r.stderr.strip().splitlines()[-1].replace(" ", ""),
                seconds=f"{enc_s + dec_s:.1f}")


def phase_sharded_gzip(data, smi):
    """sharded_compress of `data` (64 MiB) on make_mesh(4): four shards
    of 16 MiB, all on cuda:0. The output equals one gzip member per 16 MiB
    span built from oracle.deflate_encode with the same framing, and
    gzip reads it; #1 and the pack kernel launch once a shard and no
    shard is declined to the host; the screen kernel launches once a chunk
    of SCREEN_CHUNK rows of each shard. Timed (warm median of 3), and the ratio cost of the
    cut: the four members against one member of the whole buffer (the
    oracle's stream, as a buffer above MAX_DEVICE_SPAN takes). Returns
    (the launches of #1, the screen and the pack kernels, the four
    DEFLATE bodies)."""
    from concurrent.futures import ThreadPoolExecutor

    from tpz_torch import oracle
    from tpz_torch.codecs import gzip_codec
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import bitpack
    from tpz_torch.kernels import deflate_pipeline as dp
    from tpz_torch.kernels import matchfinder as mf
    from tpz_torch.kernels import parse
    from tpz_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(4, device="cuda")
    declines = dp.host_declines
    out, dt, c = drive("sharded-gzip", "mesh4-64MiB", lambda: (
        pmesh.sharded_compress(data, mesh, level=LEVEL)),
        {"parse": parse.parse_extend_v3, "screen": mf.suffix_screen,
         "pack": bitpack.pack_deflate})
    span = len(data) // 4
    spans = [data[i * span:(i + 1) * span] for i in range(4)]
    chunks = sum(-(-(-(-len(s) // mf.BLOCK)) // dp.SCREEN_CHUNK)
                 for s in spans)
    if (c["parse"] != 4 or c["pack"] != 4 or c["screen"] != chunks
            or dp.host_declines != declines):
        raise RuntimeError(f"sharded-gzip: #1 launched {c['parse']} times "
                           f"and the pack {c['pack']} (want 4 each), the "
                           f"screen {c['screen']} (want {chunks}), host "
                           f"declines {dp.host_declines - declines}")
    params = DeflateConfig(LEVEL).params_array()
    with ThreadPoolExecutor(5) as pool:
        whole = pool.submit(oracle.deflate_encode, data, params)
        bodies = list(pool.map(lambda s: oracle.deflate_encode(s, params),
                               spans))
        whole = whole.result()
    hdr = gzip_codec.header_bytes(LEVEL)
    want = b"".join(hdr + b + gzip_codec._trailer(s)
                    for s, b in zip(spans, bodies))
    if out != want:
        raise RuntimeError("sharded-gzip: members differ from the oracle's")
    if gzip.decompress(out) != data:
        raise RuntimeError("sharded-gzip: gzip round trip failed")
    median, times = warm_median(
        lambda _: pmesh.sharded_compress(data, mesh, level=LEVEL), range(3))
    one = len(hdr) + len(whole) + 8
    log("sharded-gzip", shards=4, shard_bytes=span, parse_launches=c["parse"],
        screen_launches=c["screen"], oracle_identical=True, gzip_round_trip=True, host_declines=0,
        cold_s=f"{dt:.3f}", mb_per_s=f"{len(data) / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        card=f"'{smi}'")
    log("sharded-gzip", cut_members_bytes=len(out), one_member_bytes=one,
        cut_cost_bytes=len(out) - one,
        cut_cost_share=f"{(len(out) - one) / one:.6f}",
        ratio_cut=f"{len(out) / len(data):.6f}",
        ratio_one=f"{one / len(data):.6f}")
    return c, bodies


def phase_sharded_bzip2(data, smi):
    """sharded_compress_bzip2 of `data` at level 9 on make_mesh(4) and on
    make_mesh(1) (about 73 blocks: two dispatches): the bytes are equal
    and bz2 reads them; the MTF kernel's launches counted on each. The
    mesh(4) run timed (warm median of 3). Returns its MTF launches."""
    from tpz_torch.kernels import mtf
    from tpz_torch.parallel import mesh as pmesh

    runs = {}
    for n in (4, 1):
        mesh = pmesh.make_mesh(n, device="cuda")
        runs[n] = drive("sharded-bzip2", f"mesh{n}", lambda: (
            pmesh.sharded_compress_bzip2(data, mesh, BZIP2_LEVEL)),
            {"mtf": mtf.mtf_ranks})
    if runs[4][0] != runs[1][0]:
        raise RuntimeError("sharded-bzip2: mesh(4) and mesh(1) differ")
    if bz2.decompress(runs[4][0]) != data:
        raise RuntimeError("sharded-bzip2: bz2 round trip failed")
    mesh = pmesh.make_mesh(4, device="cuda")
    median, times = warm_median(lambda _: pmesh.sharded_compress_bzip2(
        data, mesh, BZIP2_LEVEL), range(3))
    out = runs[4][0]
    log("sharded-bzip2", level=BZIP2_LEVEL,
        mesh4_mtf_launches=runs[4][2]["mtf"],
        mesh1_mtf_launches=runs[1][2]["mtf"], mesh_invariant=True,
        bz2_round_trip=True, ratio=f"{len(out) / len(data):.6f}",
        cold_s=f"{runs[4][1]:.3f}", mb_per_s=f"{len(data) / median / 1e6:.2f}",
        median_s=f"{median:.4f}", all_s=[round(t, 4) for t in times],
        card=f"'{smi}'")
    return runs[4][2]["mtf"]


def phase_sharded_step(data, bodies, smi):
    """sharded_encode_step(make_mesh(4), k=8, window=32768, block=65536)
    on the first 16 MiB of `data` (64 blocks a shard): #8 launches once a
    shard, every block's token count is positive, and is_token equals the
    plain reach route (_reach_doubling) on the same lengths on the card;
    find_matches at 1 MiB on the card equals the same call on the CPU; and
    ragged_all_gather equals ring_all_gather on the card on phase 26's
    member bodies. Returns #8's launches."""
    from tpz_torch.kernels import matchfinder as mf
    from tpz_torch.kernels import parse
    from tpz_torch.parallel import mesh as pmesh

    block, window = mf.BLOCK, mf.WINDOW
    n = 16 * MIB
    nb = n // block
    rows = torch.frombuffer(bytearray(data[:n]), dtype=torch.uint8).reshape(
        nb, block).cuda()
    span_off = torch.arange(nb, dtype=torch.int32, device="cuda") * block
    step = pmesh.sharded_encode_step(pmesh.make_mesh(4, device="cuda"), k=8,
                                     window=window, block=block)
    (mlen, _, is_token, counts), dt, c = drive(
        "sharded-step", "mesh4-16MiB", lambda: step(rows, span_off, n),
        {"reach": parse.reach_walk})
    if c["reach"] != 4 or not bool((counts > 0).all()):
        raise RuntimeError(f"sharded-step: #8 launched {c['reach']} times "
                           f"(want 4), min count {int(counts.min())}")
    steps = torch.where(mlen >= mf.MIN_MATCH, mlen, 1).to(torch.int64)
    if not torch.equal(is_token, parse._reach_doubling(steps)):
        raise RuntimeError("sharded-step: is_token differs from the plain "
                           "reach route")

    nbm = MIB // block
    span = np.zeros(window + nbm * block + mf.FWD_PAD, np.uint8)
    span[window:window + MIB] = np.frombuffer(data[:MIB], np.uint8)
    idx = (np.arange(nbm)[:, None] * block
           + np.arange(window + block + mf.FWD_PAD)[None, :])
    halo = torch.from_numpy(span[idx].astype(np.int32))
    so = torch.arange(nbm, dtype=torch.int32) * block
    t0 = time.perf_counter()
    got = mf.find_matches(halo.cuda(), so.cuda(), torch.tensor(MIB).cuda())
    torch.cuda.synchronize()
    fm_s = time.perf_counter() - t0
    want = mf.find_matches(halo, so, torch.tensor(MIB))
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise RuntimeError("find_matches differs between the card and CPU")

    mesh = pmesh.make_mesh(4, device="cuda")
    sizes = torch.tensor([len(b) for b in bodies], dtype=torch.int32)
    pay = torch.zeros((4, int(sizes.max())), dtype=torch.uint8)
    for i, b in enumerate(bodies):
        pay[i, :len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    pay, sizes = pay.cuda(), sizes.cuda()
    (ragged, total), g_ms = timed(lambda: pmesh.ragged_all_gather(mesh, pay,
                                                                 sizes))
    (ring, ring_total), r_ms = timed(lambda: pmesh.ring_all_gather(mesh, pay,
                                                                  sizes))
    cat = b"".join(bodies)
    if (not torch.equal(ragged, ring) or int(total) != int(ring_total)
            or ragged[:len(cat)].cpu().numpy().tobytes() != cat):
        raise RuntimeError("ragged and ring gathers differ")
    log("sharded-step", shards=4, blocks=nb, reach_launches=c["reach"],
        tokens=int(counts.sum()), plain_reach_equal=True,
        find_matches_card_equals_cpu=True, gathers_equal=True,
        cold_s=f"{dt:.3f}", find_matches_1MiB_s=f"{fm_s:.3f}",
        ragged_gather_ms=f"{g_ms:.3f}", ring_gather_ms=f"{r_ms:.3f}",
        gathered_bytes=int(total), card=f"'{smi}'")
    return c["reach"]


def phase_distributed(data, smi):
    """compress_sharded of `data` (64 MiB) in 16 MiB spans on the card,
    gzip and bzip2, each in a work dir: the bytes round-trip; a run with
    span 1 failing raises and its resume gives the uninterrupted bytes;
    then the two-process job (two spawned ranks on cuda:0, gloo over
    127.0.0.1) gives the one-process bytes."""
    from tpz_torch import REPO_ROOT
    from tpz_torch.kernels import mtf, parse
    from tpz_torch.parallel import distributed as pdist

    build = os.path.join(REPO_ROOT, "build")
    os.makedirs(build, exist_ok=True)
    span = 16 * MIB
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        one = {}
        for fmt, counter, read in (("gzip", parse.parse_extend_v3,
                                    gzip.decompress),
                                   ("bzip2", mtf.mtf_ranks, bz2.decompress)):
            wd = os.path.join(tmp, f"one-{fmt}")
            os.makedirs(wd)
            one[fmt], dt, c = drive("distributed", fmt, lambda: (
                pdist.compress_sharded(data, fmt, device="cuda",
                                       span_bytes=span, work_dir=wd)),
                {"kernel": counter})
            if read(one[fmt]) != data:
                raise RuntimeError(f"distributed {fmt}: round trip failed")
            log("distributed", format=fmt, spans=len(os.listdir(wd)) - 1,
                launches=c["kernel"], round_trip=True, cold_s=f"{dt:.3f}",
                mb_per_s=f"{len(data) / dt / 1e6:.2f}", card=f"'{smi}'")
        wd = os.path.join(tmp, "resume")
        os.makedirs(wd)
        try:
            pdist.compress_sharded(data, "gzip", device="cuda",
                                   span_bytes=span, work_dir=wd,
                                   fail_spans={1})
            raise RuntimeError("distributed: a failed span did not raise")
        except RuntimeError as e:
            if "span 1 incomplete" not in str(e):
                raise
        t0 = time.perf_counter()
        if pdist.compress_sharded(data, "gzip", device="cuda",
                                  span_bytes=span, work_dir=wd) != one["gzip"]:
            raise RuntimeError("distributed: the resumed run differs")
        resume_s = time.perf_counter() - t0
        torch.cuda.empty_cache()  # the ranks share this card
        two, two_s = two_process_job(data, os.path.join(tmp, "two"), span,
                                     "cuda", ("gzip", "bzip2"), timeout=300)
        if two != one:
            raise RuntimeError("distributed: the two-process job's bytes "
                               "differ from the one-process run's")
    log("distributed", fail_raised=True, resume_equal=True,
        resume_s=f"{resume_s:.3f}", two_process_equal=True, ranks=2,
        two_process_s=f"{two_s:.1f}", card=f"'{smi}'")


def distributed_rank(rank, coordinator, data, work_dir, span_bytes, device,
                     formats):
    """One rank of the two-process job (phase 29; on the CPU in
    tests/test_torch_parallel.py): it joins the gloo group at
    `coordinator`, then for each format rank 1 writes its spans into
    work_dir/<format>, both ranks meet at a barrier, and rank 0 encodes
    its own spans and assembles work_dir/<format>.out. The barrier is the
    caller's: compress_sharded's process 0 assembles without waiting."""
    import torch.distributed as dist

    from tpz_torch.parallel import distributed as pdist

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    pdist.init_distributed(coordinator, 2, rank, backend="gloo",
                           device=device)
    try:
        for fmt in formats:
            kw = dict(format=fmt, device=device, span_bytes=span_bytes,
                      work_dir=os.path.join(work_dir, fmt),
                      process_index=rank, process_count=2)
            if rank:
                if pdist.compress_sharded(data, **kw) is not None:
                    raise RuntimeError("rank 1 returned an assembly")
                if torch.device(device).type == "cuda":
                    torch.cuda.empty_cache()  # rank 0 encodes on this card
                dist.barrier()
            else:
                dist.barrier()
                blob = pdist.compress_sharded(data, **kw)
                with open(os.path.join(work_dir, fmt + ".out"), "wb") as f:
                    f.write(blob)
    finally:
        dist.destroy_process_group()


def two_process_job(data, work_dir, span_bytes, device, formats, timeout):
    """distributed_rank on two processes spawned by torch.multiprocessing,
    joined over 127.0.0.1 at a free port. Returns ({format: the assembled
    bytes}, seconds). Raises if a rank fails or outlives `timeout`
    seconds (a rank still running is killed)."""
    import socket

    import torch.multiprocessing as tmp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for fmt in formats:
        os.makedirs(os.path.join(work_dir, fmt), exist_ok=True)
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=distributed_rank, args=(
        r, f"127.0.0.1:{port}", data, work_dir, span_bytes, device, formats))
        for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    dt = time.perf_counter() - t0
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if bad:
        raise RuntimeError(f"two-process job: ranks failed or timed out "
                           f"(rank, exit code): {bad}")
    out = {}
    for fmt in formats:
        with open(os.path.join(work_dir, fmt + ".out"), "rb") as f:
            out[fmt] = f.read()
    return out, dt


def main() -> int:
    import tpz_torch  # noqa: F401 — fails at once outside a checkout
    from tpz_torch.utils import corpus
    from tpz_torch.codecs import gzip_codec

    start = time.perf_counter()

    smi = phase_device()
    phase_build()
    # The headline batch (seeds 1000, 1001) and a second one (1002, 1003)
    # that completes the sharded phases' 64 MiB.
    nb = HEADLINE_BUFFERS
    specs = [(HEADLINE_BYTES, 1000 + i) for i in range(2 * nb)]
    t0 = time.perf_counter()
    bufs = make_corpus(specs)
    log("corpus", buffers=len(bufs), seconds=f"{time.perf_counter() - t0:.1f}")
    batches = [bufs[i:i + nb] for i in range(0, len(bufs), nb)]
    small = {"mixed": corpus.mixed(MIB, seed=11),
             "repetitive": corpus.repetitive(MIB, seed=12)}
    kern = phase_kernel(batches[0], small)
    screen = phase_screen_kernel(batches[0])
    pack = phase_bitpack_kernel(batches[0])
    launches, blobs = phase_slice(batches[0])
    hdr_len = len(gzip_codec.header_bytes(LEVEL))
    walk, resolve = phase_decode_kernels(small, batches[0][0],
                                         blobs[0][hdr_len:-8])
    dec = phase_decode_slice(batches[0], blobs)
    parse_v1, lz_walk = phase_lzhuf_kernels(small["mixed"], batches[0])
    lz_pack = phase_lzhuf_pack_kernel(batches[0])
    lz_blobs, lz = phase_lzhuf_slice(batches[0], small["mixed"])
    phase_lzhuf_profile(batches[0], lz_blobs)
    lz_blob = lz_blobs[0]
    del lz_blobs
    bz_blobs, stdlib_blob, cat, small_bz, long_bz = bzip2_inputs(batches[0])
    bz_walk, bz_ibwt = phase_bzip2_kernels(small_bz, long_bz, bz_blobs)
    bz = phase_bzip2_slice(batches[0], bz_blobs, stdlib_blob, *cat)
    phase_bzip2_profile(bz_blobs)
    mtf_row = phase_bzip2_encode_kernels(batches[0])
    mtf_n = phase_bzip2_encode_slice(batches[0], bz_blobs)
    bz_blob = bz_blobs[0]
    del bz_blobs
    phase_bzip2_encode_profile(batches[0])
    reach, reach_n, v3w, v3w_n = phase_parse_kernels_8_9(batches[0], small)
    phase_decode_profile(blobs)
    phase_encode_profile(batches[0])
    data, other = batches[0]
    phase_stream_encode(data, smi)
    phase_stream_decode([
        ("gzip-16MiB", "gzip", blobs[0], data),
        ("gzip-two-members", "gzip", blobs[1] + gzip.compress(small["mixed"]),
         other + small["mixed"]),
        ("stdlib-zlib-16MiB", "zlib", zlib.compress(other, 6), other),
        ("bzip2-l9-16MiB", "bzip2", bz_blob, data),
        ("lh5-16MiB", "lh5", lz_blob, data)], smi)
    phase_lzss(data)
    crc_n, crc_row = phase_checksums(small, data, smi)
    phase_cli()
    # The sharded shape on 64 MiB: the first four headline buffers. Phase
    # 26 takes them rotated by 8 MiB, so that its cuts fall inside a
    # buffer, where a member loses context, and not at the seams between
    # two independent buffers.
    data64 = b"".join(batches[0] + batches[1])
    sharded, bodies = phase_sharded_gzip(
        data64[8 * MIB:] + data64[:8 * MIB], smi)
    sharded_mtf = phase_sharded_bzip2(data64, smi)
    step_reach = phase_sharded_step(data64, bodies, smi)
    phase_distributed(data64, smi)
    log("total", script_s=f"{time.perf_counter() - start:.1f}")
    # Each kernel's launches come from its own main-path calls: gzip encode
    # and sharded_compress (#1, the screen, the DEFLATE pack), gzip decode
    # (#2, #3), lh5 encode (#4, the LZHUF pack), lh5 decode (#5), bzip2
    # decode (#6, #7), the public function greedy_parse and
    # sharded_encode_step (#8), parse_extend_v3w (#9), bzip2 encode and
    # sharded_compress_bzip2 on make_mesh(4) (the MTF encode), and
    # checksums.crc32 on the card (the CRC lanes).
    rows = [("parse_walk_v3", "parse_walk.cu", "tpz/kernels/parse.py:464",
             launches["parse"] + sharded["parse"], kern),
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
             reach_n + step_reach, reach),
            ("parse_walk_v3w", "parse_walk.cu", "tpz/kernels/parse.py:211",
             v3w_n, v3w),
            ("mtf_encode", "mtf_encode.cu", "tpz/kernels/mtf.py:36",
             mtf_n + sharded_mtf, mtf_row),
            ("crc32_lanes", "crc32_lanes.cu",
             "tpz/kernels/checksums.py:104", crc_n, crc_row),
            ("suffix_screen_v3", "suffix_screen.cu",
             "none (XLA stage tpz/kernels/matchfinder.py::suffix_screen_w)",
             launches["screen"] + sharded["screen"], screen),
            ("deflate_pack", "deflate_pack.cu",
             "none (XLA stage tpz/kernels/bitpack.py::assemble_stream_v2)",
             launches["pack"] + sharded["pack"], pack),
            ("lzhuf_pack", "lzhuf_pack.cu",
             "none (XLA stage tpz/kernels/lzhuf_pipeline.py::_stage2 with "
             "tpz/kernels/bitpack.py::assemble_stream_msb)", lz["pack"],
             lz_pack)]
    # None of these functions has one PyTorch call that computes it (torch
    # has no CRC).
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
