"""Batched LZHUF (LHA lh4-lh7) decode on one torch device (port of
tpz/kernels/lzhuf_walk.py).

The DEFLATE segmented route's analogue: the host token indexer (cpp
LzhufIndex) walks the token stream once, writing no output, and cuts it
into token-aligned segments of at most 64 KiB of output (also at every
block's table change) with split-match carries; then, stage by stage
(the names `stage_hook` receives):
  index        (host) the token indexer
  tables       (host) each block's two-level decode tables (build_tables)
  layout       (host) per-segment stream slices and fused table rows
  h2d          the layout copied to the device
  walk         the MSB token walk: every segment decoded in parallel into
               markers [nseg, BLOCK] (CUDA kernel on a card)
  materialize  dead-tail blanking and carry markers (inflate_pipeline's
               _materialize_fn), then placement into dense output space
  resolve      the LZ77 copy machine with dist_bias=1 (LZHUF markers
               store dist - 1)
  fetch        device-to-host copy, cut per stream
Bit order is MSB first (LHA); the c alphabet has 510 symbols (bytes, then
match lengths 3..256) and p up to 20 (the distance's bit count).

The reference's limits stay: a stream longer than 2^24 bytes, one the
indexer refuses or that has no segment, a segment slice above
SLICE_BYTES, or a block whose long codes overflow the level-2 table
(build_tables -> None) goes to the host decoder (cpp LzhufDecode), and
each such decline is counted in `host_declines`. A batch above 2^24
output bytes splits in halves.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch import constants as C
from tpz_torch import oracle
from tpz_torch.kernels.deflate_pipeline import _device, _nohook
from tpz_torch.kernels.inflate_pipeline import (BLOCK, _KIND_LIT, _KIND_MATCH,
                                                _materialize_fn, _place_dense,
                                                _to_device)
from tpz_torch.kernels.resolve_walk import resolve_dense
from tpz_torch.utils.bits import U32, as_u32, to_i32

NC = C.LZHUF_NC
# Two-level decode tables: a 12-bit level 1 (4096 entries) and level-2
# chunks of 32 entries per escaped 12-bit prefix (codes run to 17 bits).
L1_BITS = 12
L1W = 1 << L1_BITS
L2_CAP = 4096
TW = 2 * (L1W + L2_CAP)          # fused [c L1 | c L2 | p L1 | p L2]
OC2, OP1, OP2 = L1W, L1W + L2_CAP, 2 * L1W + L2_CAP
SLICE_BYTES = BLOCK + 16384      # LZHUF's worst expansion ~9/8 + tables
MAX_STREAM = 1 << 24             # longer streams go to the host decoder
MAX_BATCH = 1 << 24              # packed-pointer bound of one resolve

# Streams handed to the host decoder because the device path declined
# their shape (see the module docstring).
host_declines = 0


def _host_decode(data: bytes, orig_size: int, dict_bits: int) -> bytes:
    global host_declines
    host_declines += 1
    return oracle.lzhuf_decode(data, orig_size, dict_bits)


def build_tables(lens: np.ndarray, consts: np.ndarray, nsym: int):
    """lens [NBLK, nsym] uint8 code lengths -> (l1 [NBLK, L1W], l2 [NBLK,
    L2_CAP]) int32 MSB canonical decode tables, or None when a block's long
    codes overflow L2_CAP. consts[b] >= 0 fills the whole level 1 with
    const << 5 | 0: a 0-bit entry that always matches."""
    NB = lens.shape[0]
    l1 = np.zeros((NB, L1W), np.int32)
    l2 = np.zeros((NB, L2_CAP), np.int32)
    for b in range(NB):
        if consts[b] >= 0:
            l1[b, :] = int(consts[b]) << 5
            continue
        lr = lens[b, :nsym].astype(np.int64)
        order = np.lexsort((np.arange(nsym), lr))
        order = order[lr[order] > 0]
        if order.size == 0:
            continue
        ls = lr[order]
        c = 0
        prev = int(ls[0])
        l2n = 0
        esc = {}
        for i in range(ls.size):
            L = int(ls[i])
            c <<= L - prev
            prev = L
            sym = int(order[i])
            if L <= L1_BITS:
                lo = c << (L1_BITS - L)
                l1[b, lo:lo + (1 << (L1_BITS - L))] = (sym << 5) | L
            else:
                pre = c >> (L - L1_BITS)
                if pre not in esc:
                    if l2n + 32 > L2_CAP:
                        return None
                    esc[pre] = l2n
                    l1[b, pre] = (l2n << 5) | 31
                    l2n += 32
                suf = c & ((1 << (L - L1_BITS)) - 1)
                w = 1 << (L1_BITS + 5 - L)
                s0 = esc[pre] + (suf << (L1_BITS + 5 - L))
                l2[b, s0:s0 + w] = (sym << 5) | L
            c += 1
    return l1, l2


# ------------------------------------------------------------- the walk

def lzhuf_walk_plain(stream_words, body_bit_local, out_len, start_pos, tab):
    """The plain version of the token walk (the reference's lane-parallel
    _walk_vz): every segment advances one token per loop trip, so the
    trip count is the largest token count of any segment.

    stream_words [NB, SW] int32 (big-endian u32 words of each segment's
    slice); body_bit_local, out_len, start_pos [NB] int32; tab [NB, TW]
    int32 fused tables. Returns markers [NB, BLOCK] int32: one at each
    token's output position, 0 elsewhere. Words ride in int64, so shifts
    are logical (H2/H3)."""
    NB, SW = stream_words.shape
    TWr = tab.shape[1]
    dev = stream_words.device
    s_flat = as_u32(stream_words).reshape(-1)
    t_flat = as_u32(tab).reshape(-1)
    seg = torch.arange(NB, device=dev, dtype=torch.int64)
    s_base = seg * SW
    t_base = seg * TWr
    o_base = seg * (BLOCK + 1)
    ol = out_len.to(torch.int64)
    bitpos = body_bit_local.to(torch.int64)
    out_pos = start_pos.to(torch.int64)
    # Column BLOCK takes the writes of finished segments.
    out = torch.zeros(NB * (BLOCK + 1), dtype=torch.int32, device=dev)

    trip = 0
    while trip % 16 or bool((out_pos < ol).any()):
        trip += 1
        act = out_pos < ol
        sh = bitpos & 31
        wc = s_base + torch.clamp(bitpos >> 5, 0, SW - 3)
        w0, w1, w2 = s_flat[wc], s_flat[wc + 1], s_flat[wc + 2]

        def bits_at(off, n):
            # MSB: n bits starting sh + off into the 96-bit window.
            b = sh + off
            wi = b >> 5
            s2 = b & 31
            lo = torch.where(wi == 0, w0, torch.where(wi == 1, w1, w2))
            hi = torch.where(wi == 0, w1, torch.where(wi == 1, w2, 0))
            v = ((lo << s2) & U32) | torch.where(s2 > 0, hi >> (32 - s2), 0)
            if isinstance(n, int):
                return v >> (32 - n)
            return torch.where(n > 0, v >> ((32 - n) & 31), 0)

        def lookup(l1, l2, off):
            e = t_flat[t_base + l1 + bits_at(off, L1_BITS)]
            e2 = t_flat[t_base + torch.clamp(
                l2 + (e >> 5) + bits_at(off + L1_BITS, 5), max=TWr - 1)]
            return torch.where((e & 31) == 31, e2, e)

        e = lookup(0, OC2, 0)
        clen = e & 31
        csym = e >> 5
        is_match = csym >= 256
        mlen = torch.clamp(csym - 253, 3, 258)
        pe = lookup(OP1, OP2, clen)
        plen = pe & 31
        pc = pe >> 5
        raw_n = torch.clamp(pc - 1, min=0)
        raw = bits_at(clen + plen, raw_n)
        top = torch.where(raw_n < 32, 1 << torch.clamp(raw_n, max=31), 0)
        pval = torch.where(pc > 1, top | raw, pc)
        nbits = torch.where(is_match, clen + plen + raw_n, clen)
        adv = torch.where(is_match, mlen, 1)
        mark = torch.where(is_match,
                           (_KIND_MATCH << 28) | ((pval << 9) & U32) | mlen,
                           (_KIND_LIT << 28) | csym)

        col = torch.where(act, out_pos, BLOCK)
        out.index_put_((o_base + col,), to_i32(mark))
        bitpos = torch.where(act, bitpos + nbits, bitpos)
        out_pos = torch.where(act, out_pos + adv, out_pos)
    return out.reshape(NB, BLOCK + 1)[:, :BLOCK]


def lzhuf_walk(stream_words, body_bit_local, out_len, start_pos, tab):
    """The token walk: the plain version for CPU tensors, the CUDA kernel
    (csrc/lzhuf_walk.cu) for CUDA tensors. Arguments as lzhuf_walk_plain;
    all int32 and contiguous."""
    args = (stream_words, body_bit_local, out_len, start_pos, tab)
    if stream_words.device.type == "cpu":
        return lzhuf_walk_plain(*args)
    if stream_words.device.type != "cuda":
        raise ValueError(f"lzhuf walk: unsupported device "
                         f"{stream_words.device}")
    NB, SW = stream_words.shape
    shapes = ((NB, SW), (NB,), (NB,), (NB,), (NB, TW))
    names = ("stream_words", "body_bit_local", "out_len", "start_pos", "tab")
    for name, t, shape in zip(names, args, shapes):
        if (t.device != stream_words.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lzhuf walk: {name} must be a contiguous int32 tensor of "
                f"shape {shape} on {stream_words.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if SW < 3:
        raise ValueError(f"lzhuf walk: slices of {SW} words, need >= 3")
    out = torch.zeros((NB, BLOCK), dtype=torch.int32,
                      device=stream_words.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(stream_words.device):
        rc = _build.lib().tpz_lzhuf_walk(
            *(t.data_ptr() for t in args), out.data_ptr(), NB, SW,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lzhuf walk kernel launch failed: cudaError {rc}")
    lzhuf_walk.launches += 1
    return out


lzhuf_walk.launches = 0


# ------------------------------------------------------- device stages

def _walk_args(t: dict) -> tuple:
    """The walk's arguments from a device layout."""
    return (t["stream_words"], t["body_bit_local"], t["out_len"],
            t["carry_len"], t["tab"])


def _dense_markers(markers, t: dict) -> torch.Tensor:
    """The walk's markers with dead tails blanked and carry markers
    written (no stored blocks in LZHUF), placed at dense_off + pos."""
    NB = markers.shape[0]
    zeros = torch.zeros(NB, dtype=torch.int32, device=markers.device)
    markers = _materialize_fn(markers, zeros[:, None], zeros + 1, zeros,
                              zeros, zeros, t["out_len"], carry=t["carry"])
    return _place_dense(markers, t)


def _decode(t: dict, stage_hook=_nohook) -> torch.Tensor:
    """Walk, materialize and place, resolve with dist_bias=1. Returns
    [total rounded up to 128] uint8."""
    markers = lzhuf_walk(*_walk_args(t))
    stage_hook("walk")
    dense = _dense_markers(markers, t)
    stage_hook("materialize")
    out = resolve_dense(dense, dist_bias=1)
    stage_hook("resolve")
    return out


# ---------------------------------------------------------- host layout

def _segment_tables(idx: dict, np_: int):
    """Fused table rows [nseg, TW] int32 for an index's segments, or None
    when a block's tables overflow L2_CAP."""
    ct = build_tables(idx["c_lens"], idx["c_consts"], NC)
    pt = build_tables(idx["p_lens"], idx["p_consts"], np_)
    if ct is None or pt is None:
        return None
    bid = idx["block_ids"]
    return np.concatenate([ct[0][bid], ct[1][bid], pt[0][bid], pt[1][bid]],
                          axis=1)


def _layout(entries) -> dict:
    """Host arrays for the device stages. entries: per stream (body
    bytes, index dict, per-segment slice spans, fused table rows)."""
    nseg = sum(len(e[1]["out_lens"]) for e in entries)
    slices = np.zeros((nseg, SLICE_BYTES), np.uint8)
    L = {k: np.zeros(nseg, np.int32)
         for k in ("body_bit_local", "out_len", "carry_len", "carry")}
    tab = np.zeros((nseg, TW), np.int32)
    s0 = 0
    for data, idx, spans, rows in entries:
        k = len(idx["out_lens"])
        sb = np.frombuffer(data, np.uint8)
        for s in range(k):
            p0 = int(idx["seg_bits"][s]) // 8
            take = min(int(spans[s]), len(data) - p0)
            slices[s0 + s, :take] = sb[p0:p0 + take]
        sl = slice(s0, s0 + k)
        L["body_bit_local"][sl] = idx["seg_bits"] & 7
        L["out_len"][sl] = idx["out_lens"]
        cl = idx["carry_len"].astype(np.int32)
        L["carry_len"][sl] = cl
        cv = ((idx["carry_dist"].astype(np.int32) - 1).clip(0) << 9) | cl
        L["carry"][sl] = np.where(cl > 0, cv, 0)
        tab[sl] = rows
        s0 += k
    L["stream_words"] = slices.view(">u4").astype(np.int32)
    L["tab"] = tab
    ol = L["out_len"].astype(np.int64)
    L["dense_off"] = np.cumsum(ol) - ol
    return L


# ----------------------------------------------------- host entry points

def decompress(data: bytes, orig_size: int, dict_bits: int,
               device="cuda") -> bytes:
    """Decode one raw LZHUF body of `orig_size` output bytes."""
    return decompress_many([(data, orig_size)], dict_bits, device)[0]


def decompress_many(items, dict_bits: int, device="cuda", *,
                    stage_hook=_nohook) -> list[bytes]:
    """Batch decode: every stream's segments share one device walk and
    one resolve (valid streams' matches never reach before their own
    start, and the indexer checked every distance, so the streams share
    one dense output space). items: (body bytes, orig_size). Declined
    streams decode on the host (counted in host_declines)."""
    device = _device(device)
    items = list(items)
    results = [None] * len(items)
    cand = []
    for i, (data, orig_size) in enumerate(items):
        if orig_size == 0:
            results[i] = b""
            continue
        idx = (oracle.lzhuf_index(data, orig_size, dict_bits, seg_out=BLOCK)
               if orig_size <= MAX_STREAM else None)
        if idx is None or len(idx["out_lens"]) == 0:
            results[i] = _host_decode(data, orig_size, dict_bits)
            continue
        spans = (idx["end_bits"] + 7) // 8 + 1 - idx["seg_bits"] // 8
        if int(spans.max()) > SLICE_BYTES:
            results[i] = _host_decode(data, orig_size, dict_bits)
            continue
        cand.append((i, idx, spans))
    stage_hook("index")
    _decode_groups(items, cand, dict_bits, device, results, stage_hook)
    return results


def _decode_groups(items, cand, dict_bits, device, results,
                   stage_hook) -> None:
    """Decode the indexed streams `cand` ((item index, index dict, slice
    spans)) into results, in halves while their output passes MAX_BATCH
    (the packed-pointer bound of one resolve)."""
    if not cand:
        return
    if len(cand) > 1 and sum(items[i][1] for i, _, _ in cand) > MAX_BATCH:
        half = len(cand) // 2
        for part in (cand[:half], cand[half:]):
            _decode_groups(items, part, dict_bits, device, results,
                           stage_hook)
        return
    np_ = oracle._lzhuf_np(dict_bits)
    entries, kept = [], []
    for i, idx, spans in cand:
        rows = _segment_tables(idx, np_)
        if rows is None:
            results[i] = _host_decode(items[i][0], items[i][1], dict_bits)
            continue
        entries.append((items[i][0], idx, spans, rows))
        kept.append(i)
    stage_hook("tables")
    if not kept:
        return
    layout = _layout(entries)
    stage_hook("layout")
    t = _to_device(layout, device)
    stage_hook("h2d")
    flat = _decode(t, stage_hook).cpu().numpy()
    pos = 0
    for i in kept:
        n_out = items[i][1]
        results[i] = flat[pos:pos + n_out].tobytes()
        pos += n_out
    stage_hook("fetch")
