"""Roofline models for the port's device paths (port of
tpz/utils/roofline.py).

Each benchmarked path gets a coarse WORK COUNT: the primitive calls the
port itself launches for `nbytes` of input, counted from its own
constants (the DEFLATE screen's WINDOW, BLOCK, FWD_PAD and SCREEN_CHUNK,
the level's screen width, neighbours and restart; the LZHUF blocks; the
bzip2 block buckets). Each count is priced at a rate measured on the card
(`measure_rates`, once per process) or, for the hand kernels, at the
card's int32 peak; the sum is a least time for the path, and a bench row
reports its MB/s as a share of the MB/s that least time allows. A path
near 100% is bound by the primitives it calls; one at 5% spends its time
elsewhere (host stages, transfers, small launches).

Where the reference priced the TPU's measured walk floors
(`walk_positions_per_s`, `v3z_trips_per_s`), the port prices the walk
kernels' own work: the trips the least demanding data of that size would
take, times the operations a trip costs, counted by hand from the CUDA
sources (the OPS_* below, which chip_smoke.py's kernel bounds use too).
Where the reference priced a relay dispatch (0.6 s), the port prices the
host-device round trips a call makes at the measured round trip of one
tiny launch and a synchronize.

The card's peaks are keyed by its name (`PEAKS`); a card not in the table
gets no roofline.
"""

from __future__ import annotations

import functools
import statistics
import time

import torch

from tpz_torch import constants as C
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.kernels import (bzip2_pipeline, inflate_pipeline,
                               lzhuf_pipeline)
from tpz_torch.kernels.deflate_pipeline import SCREEN_CHUNK
from tpz_torch.kernels.matchfinder import (BLOCK, M_TOTAL, MAX_MATCH,
                                           _sort_perm)

# NVIDIA's H100 SXM datasheet (700 W): 3.35 TB/s, and 67 T/s float32
# outside the tensor cores, i.e. 132 SMs x 128 FP32 lanes x 2 (an FMA) x
# 1.98 GHz. An SM has 64 INT32 lanes (NVIDIA's Hopper architecture
# whitepaper), so int32 issues at 67e12 / 2 / 2 per second.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "int_ops_per_s": 67e12 / 4},
}
# The card chip_smoke.py's kernel bounds are priced for.
HBM_BYTES_PER_S = PEAKS["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"]
INT_OPS_PER_S = PEAKS["NVIDIA H100 80GB HBM3"]["int_ops_per_s"]

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

LEVEL = 6                  # the DEFLATE rows' level (the bench's headline)
BZIP2_LEVEL = 9            # the bzip2 rows' level (the codec's default)
LZHUF_METHOD = "lh5"


def peaks(card: str) -> dict | None:
    """The card's peak rates, or None for a card not in PEAKS (never
    another card's figures)."""
    return PEAKS.get(card)


def bound(tensors, ops) -> dict:
    """bound_ms and bound_by for a kernel call on an H100 that reads or
    writes each of `tensors` once and does `ops` int32 operations."""
    return bound_bytes_ops(sum(t.numel() * t.element_size()
                               for t in tensors), ops)


def bound_bytes_ops(nbytes, ops) -> dict:
    """bound_ms and bound_by for a kernel call on an H100 that moves
    `nbytes` and does `ops` int32 operations."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(ms_bytes, ms_ops),
            "bound_by": "bytes" if ms_bytes >= ms_ops else "operations"}


# ------------------------------------------------------------ the rates

def _seconds(fn, device: torch.device, reps: int) -> float:
    """Mean seconds of fn() over `reps` warm calls: CUDA events on a card,
    the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _round_trip_s(device: torch.device, reps: int) -> float:
    """Median host seconds of one tiny launch and a synchronize."""
    tiny = torch.zeros(1, dtype=torch.int32, device=device)
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        tiny.add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:])


@functools.cache
def _measure(device: str, rows: int, m: int, reps: int) -> tuple:
    dev = torch.device(device)
    g = torch.Generator(device="cpu").manual_seed(0)
    n = rows * m

    def rand(lo, hi, dtype):
        return torch.randint(lo, hi, (rows, m), generator=g,
                             dtype=dtype).to(dev)

    k64 = rand(-(1 << 62), 1 << 62, torch.int64)
    # The level's screen keys: screen_bytes / 4 words and the flag.
    nw = DeflateConfig(LEVEL).screen_bytes // 4
    keys = [rand(-(1 << 31), 1 << 31, torch.int32) for _ in range(nw)]
    flag = rand(0, 2, torch.int32)
    x = rand(-(1 << 31), 1 << 31, torch.int32)
    perm = torch.argsort(rand(0, 1 << 30, torch.int32), dim=1)
    out = torch.empty_like(x)
    rates = {
        "sort_keys_per_s": n / _seconds(
            lambda: torch.sort(k64, dim=1, stable=True), dev, reps),
        "sort3_keys_per_s": n / _seconds(
            lambda: _sort_perm(keys, flag), dev, reps),
        "cumsum_elems_per_s": n / _seconds(
            lambda: torch.cumsum(x, dim=1, dtype=torch.int32), dev, reps),
        "gather_elems_per_s": n / _seconds(
            lambda: torch.gather(x, 1, perm), dev, reps),
        # One int32 read and one written an element.
        "elementwise_bytes_per_s": 8 * n / _seconds(
            lambda: torch.bitwise_xor(x, 0x5A5A5A5A, out=out), dev, reps),
        "launch_round_trip_s": _round_trip_s(dev, 10 * reps),
    }
    return tuple(rates.items())


def measure_rates(device="cuda", rows: int = SCREEN_CHUNK,
                  m: int = M_TOTAL, reps: int = 5) -> dict:
    """Primitive rates on `device`, measured once a process for each
    shape: a 1-key stable int64 sort of each row (keys/s), the screen's
    chained stable sort (`matchfinder._sort_perm` on the level's key words
    and flag; positions/s), an int32 row cumsum and a row gather by a
    permutation (elements/s), an int32 elementwise pass (bytes read and
    written /s), and the round trip of one tiny launch and a synchronize
    (s). The default shape is one screen chunk of the DEFLATE headline:
    SCREEN_CHUNK rows of M_TOTAL positions; a few KB would time the
    launch overhead alone."""
    return dict(_measure(str(torch.device(device)), rows, m, reps))


# ------------------------------------------------------- the work models

def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _split(nbytes: int, buffers: int) -> list[int]:
    """nbytes as `buffers` buffers of equal size (the first ones take the
    remainder)."""
    q, r = divmod(nbytes, buffers)
    return [q + (i < r) for i in range(buffers)]


def deflate_layout(nbytes: int, buffers: int = 1) -> tuple[int, int]:
    """(NB, M): the screen rows `deflate_pipeline.span_layout` lays out
    for `buffers` buffers of nbytes in all, and their positions."""
    return (sum(_ceil(n, BLOCK) for n in _split(nbytes, buffers)),
            M_TOTAL)


def deflate_encode_model(nbytes: int, buffers: int = 1,
                         level: int = LEVEL) -> dict:
    """gzip/DEFLATE encode (`deflate_pipeline._fused_encode`) on
    deflate_layout's NB rows of M = WINDOW + BLOCK + FWD_PAD positions:

    - screen sort: one `_sort_perm` a row (the level's screen_bytes / 4
      key words and the flag; chunks of SCREEN_CHUNK rows, the rate's
      shape) -> sort3 keys NB * M;
    - the sorted keys and flag gathered by the permutation, both packed
      candidates scattered back -> (nw + 3) * NB * M gathers;
    - the neighbour scan: 2 * max_chain shifts, each rolling the sorted
      positions and nw key words (8 bytes each read and written; the
      compares and top-2 updates not counted) -> elementwise bytes;
    - #1, the parse walk: the fewest tokens nbytes can take, every one a
      MAX_MATCH match extended from the screen -> int32 operations;
    - bitpack: one prefix sum over a slot a position -> cumsum NB * BLOCK;
    - two round trips: the plan's end bits and the fetch.

    Departs from the reference's model: no lax.map groups of 16 blocks,
    no v3z walk trips and no relay dispatch; the screen sorts nw words
    and the flag by chained int64 sorts (H4), timed as one primitive."""
    cfg = DeflateConfig(level)
    nb, m = deflate_layout(nbytes, buffers)
    nw = cfg.screen_bytes // 4
    tokens = _ceil(nbytes, MAX_MATCH)
    return {
        "sort3_keys_count": nb * m,
        "gather_elems_count": (nw + 3) * nb * m,
        "elementwise_bytes_count": 2 * cfg.max_chain * (nw + 1) * 8 * nb * m,
        "kernel_ops_count": tokens * (
            OPS_V3_TOKEN
            + (MAX_MATCH - cfg.screen_bytes) // 4 * OPS_V3_EXTEND),
        "cumsum_elems_count": nb * BLOCK,
        "dispatch": 2,
    }


def deflate_decode_model(nbytes: int, buffers: int = 1) -> dict:
    """Segmented inflate (`inflate_pipeline._decode_segmented_fn`): a
    segment of at most BLOCK output bytes a row:

    - #2, the symbol walk: the fewest tokens nbytes can take, every one a
      MAX_MATCH match; #3, the copy machine: every output position's
      state -> int32 operations;
    - materialize (the [segments, BLOCK] int32 markers read and written)
      and the placement into dense output space (nbytes int32 markers
      read and written) -> elementwise bytes;
    - one round trip: the fetch.

    Departs from the reference's model: the walk is priced at the
    kernel's int32 operations, not a measured walk floor; no relay
    dispatch."""
    seg = sum(_ceil(n, inflate_pipeline.BLOCK)
              for n in _split(nbytes, buffers))
    return {
        "kernel_ops_count": (_ceil(nbytes, MAX_MATCH) * OPS_SYMBOL_MATCH
                             + nbytes * OPS_COPY_POSITION),
        "elementwise_bytes_count": 8 * (seg * inflate_pipeline.BLOCK
                                        + nbytes),
        "dispatch": 1,
    }


def _bzip2_rows(nbytes: int, buffers: int, level: int) -> int:
    """Padded positions of the bzip2 blocks nbytes fills: blocks of up to
    level * 100 k bytes (as if RLE1 removed nothing), each padded to its
    bucket N (`bzip2_pipeline._bucket`)."""
    cap = level * C.BZIP2_BLOCK_UNIT
    return sum(_ceil(n, cap) * bzip2_pipeline._bucket(min(n, cap))
               for n in _split(nbytes, buffers) if n)


def bzip2_encode_model(nbytes: int, buffers: int = 1,
                       level: int = BZIP2_LEVEL) -> dict:
    """bzip2 encode (`bzip2_pipeline._fused_bwt_mtf`, then the plan and
    the MSB pack) over P padded block positions:

    - BWT: the depth-4 ranks and the final rotation order, one flat 1-key
      stable sort each; the doubling rounds between (data-dependent) are
      not counted -> sort keys 2 * P;
    - the first ranks' prefix sum and scatter, the last column's two
      gathers -> cumsum P, gathers 3 * P;
    - MTF encode: a symbol an input byte, no list moves counted -> int32
      operations;
    - three round trips: the first round's check, the block lengths and
      the fetch.

    Departs from the reference's model: no "6 rounds" of 3-key sorts (the
    port's rounds sort one packed int64 key and depend on the data); no
    relay dispatch."""
    p = _bzip2_rows(nbytes, buffers, level)
    return {
        "sort_keys_count": 2 * p,
        "cumsum_elems_count": p,
        "gather_elems_count": 3 * p,
        "kernel_ops_count": nbytes * OPS_MTF_ENCODE,
        "dispatch": 3,
    }


def bzip2_decode_model(nbytes: int, buffers: int = 1,
                       level: int = BZIP2_LEVEL) -> dict:
    """bzip2 decode (`bzip2_walk.decode_blocks_device`) over P padded
    block positions:

    - the iBWT's LF order: one 1-key sort of P int64 keys;
    - #7, the iBWT: a step a node (an input byte) -> int32 operations
      (#6's symbol walk, whose symbols the data sets, is not counted);
    - the records expanded to int32 and a byte out a position ->
      elementwise bytes 5 * P;
    - one round trip: the fetch.

    Departs from the reference's model: walks priced at the kernels'
    int32 operations, not a measured walk floor; no relay dispatch."""
    p = _bzip2_rows(nbytes, buffers, level)
    return {
        "sort_keys_count": p,
        "kernel_ops_count": nbytes * OPS_IBWT_STEP,
        "elementwise_bytes_count": 5 * p,
        "dispatch": 1,
    }


def lzhuf_layout(nbytes: int, buffers: int = 1,
                 method: str = LZHUF_METHOD) -> tuple[int, int]:
    """(NB, M): the blocks `lzhuf_pipeline.make_blocks` lays out, each
    with its 2^dict_bits halo and FWD bytes."""
    window = 1 << C.LZHUF_METHODS[method][0]
    return (sum(_ceil(n, lzhuf_pipeline.BLOCK)
                for n in _split(nbytes, buffers)),
            window + lzhuf_pipeline.BLOCK + lzhuf_pipeline.FWD)


def lzhuf_encode_model(nbytes: int, buffers: int = 1,
                       method: str = LZHUF_METHOD) -> dict:
    """LZHUF encode (`lzhuf_pipeline._stage1`, `_stage2`) on lzhuf_layout's
    NB rows of M positions:

    - the v1 screen: one 1-key int64 sort a row -> sort keys NB * M;
    - the two word arrays and the caps gathered by the permutation, the
      winner and its screen scattered back -> gathers 5 * NB * M;
    - MAX_CHAIN neighbours, each rolling the two sorted word arrays
      (8 bytes each read and written) -> elementwise bytes;
    - #4, the v1 parse walk: the fewest tokens nbytes can take, every one
      a MAX_MATCH match extended from its 8-byte screen -> int32
      operations;
    - the MSB pack's prefix sum over a slot a position -> cumsum;
    - two round trips: the histograms and the fetch (the host plan
      between them is not counted).

    Departs from the reference's model (which reused the decode's): the
    encode is counted on its own."""
    nb, m = lzhuf_layout(nbytes, buffers, method)
    mm = C.LZHUF_MAX_MATCH
    return {
        "sort_keys_count": nb * m,
        "gather_elems_count": 5 * nb * m,
        "elementwise_bytes_count": lzhuf_pipeline.MAX_CHAIN * 16 * nb * m,
        "kernel_ops_count": _ceil(nbytes, mm) * (
            OPS_V1_VISIT + (mm - 8) // 4 * OPS_V1_EXTEND),
        "cumsum_elems_count": nb * lzhuf_pipeline.BLOCK,
        "dispatch": 2,
    }


def lzhuf_decode_model(nbytes: int, buffers: int = 1) -> dict:
    """LZHUF decode (`lzhuf_walk._decode`): #5's token walk (the fewest
    tokens nbytes can take, every one a match) and #3's copy machine (a
    state an output position) -> int32 operations; the markers
    materialized and placed (nbytes int32 read and written twice) ->
    elementwise bytes; one round trip, the fetch. Departs from the
    reference's model (the DEFLATE decode's walk floor): the walk is
    priced at the kernel's int32 operations."""
    return {
        "kernel_ops_count": (_ceil(nbytes, C.LZHUF_MAX_MATCH)
                             * OPS_LZHUF_MATCH + nbytes * OPS_COPY_POSITION),
        "elementwise_bytes_count": 16 * nbytes,
        "dispatch": 1,
    }


MODELS = {
    "deflate_encode_device": deflate_encode_model,
    "deflate_decode_device": deflate_decode_model,
    "deflate_decode_device_batched": deflate_decode_model,
    "deflate_decode_device_foreign": deflate_decode_model,
    "bzip2_encode_device": bzip2_encode_model,
    "bzip2_decode_device": bzip2_decode_model,
    "lzhuf_encode_device": lzhuf_encode_model,
    "lzhuf_encode_device_batched": lzhuf_encode_model,
    "lzhuf_decode_device": lzhuf_decode_model,
}


def _price(work: dict, rates: dict, card_peaks: dict) -> tuple[float, dict]:
    """work: {primitive: count} -> (seconds lower bound, per-term secs)."""
    terms = {}
    for k, n in work.items():
        if k == "dispatch":
            terms[k] = n * rates["launch_round_trip_s"]
        elif k == "kernel_ops_count":
            terms[k] = n / card_peaks["int_ops_per_s"]
        else:
            terms[k] = n / rates[k.replace("_count", "_per_s")]
    return sum(terms.values()), terms


def annotate(name: str, nbytes: int, achieved_mb_s: float, *,
             rates: dict, card: str, buffers: int = 1) -> dict | None:
    """Roofline annotation for one bench row of `buffers` buffers: the
    achievable MB/s from the work model priced at `rates`
    (measure_rates) and the peaks of `card` (its name), the share of it
    achieved, and the two dominant cost terms. None for a row with no
    model, no rate achieved, or a card not in PEAKS."""
    model = MODELS.get(name)
    card_peaks = peaks(card)
    if model is None or not achieved_mb_s or card_peaks is None:
        return None
    secs, terms = _price(model(nbytes, buffers), rates, card_peaks)
    kern_secs = secs - terms.get("dispatch", 0.0)
    achievable = nbytes / secs / 1e6
    top = sorted(terms.items(), key=lambda kv: -kv[1])[:2]
    out = {
        # With the round trips: the ceiling of one call at this size.
        "achievable_MB_s": achievable,
        "pct_of_achievable": 100.0 * achieved_mb_s / achievable,
        "dominant_terms": dict(top),
    }
    if kern_secs > 0:
        # Without them: the primitive-priced ceiling, the figure a faster
        # stage must move.
        kern_achievable = nbytes / kern_secs / 1e6
        out["kernel_achievable_MB_s"] = kern_achievable
        out["pct_of_kernel"] = 100.0 * achieved_mb_s / kern_achievable
    return out
