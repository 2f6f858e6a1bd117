"""Batched LZHUF (LHA lh4-lh7) decode on one torch device (port of
tpz/kernels/lzhuf_walk.py).

The DEFLATE segmented route's analogue: the host token indexer (cpp
LzhufIndex) walks the token stream once, writing no output, and cuts it
into token-aligned segments of at most 64 KiB of output (also at every
block's table change) with split-match carries; then, stage by stage
(each the span tpz_torch.lzhuf.<name>; the names `stage_hook` receives):
  index        (host) the token indexer
  tables       (host) each block's two-level decode tables (build_tables)
  layout       (host) per-segment stream slices and fused table rows
  h2d          the layout copied to the device
  walk         the MSB token walk: every segment decoded in parallel into
               markers [nseg, BLOCK] (CUDA kernel on a card: lanes a
               segment, each walked from every phase near its guessed
               bit, stitched by lookup)
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
from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.kernels._build import SHARED_LIMIT
from tpz_torch.kernels.inflate_pipeline import (BLOCK, _KIND_LIT, _KIND_MATCH,
                                                _materialize_fn, _place_dense,
                                                _to_device)
from tpz_torch.kernels.resolve_walk import resolve_dense
from tpz_torch.utils.profiling import _nohook, span, stage
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
    with span("lzhuf.host_decline"):
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
    token's output position, 0 elsewhere."""
    NB = stream_words.shape[0]
    dev = stream_words.device
    decode = _token_decoder(stream_words, tab)
    seg = torch.arange(NB, device=dev, dtype=torch.int64)
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
        nbits, adv, mark = decode(seg, bitpos)
        col = torch.where(act, out_pos, BLOCK)
        out.index_put_((o_base + col,), to_i32(mark))
        bitpos = torch.where(act, bitpos + nbits, bitpos)
        out_pos = torch.where(act, out_pos + adv, out_pos)
    return out.reshape(NB, BLOCK + 1)[:, :BLOCK]


# The lane walk (csrc/lzhuf_walk.cu): lanes a segment and phase walks a
# lane (the true walk enters a lane's range at most 26 bits past its guess
# on the lh5 headline of chip_smoke.py, 22 on lh7; an entry later than the
# phases cover takes the slow route). The result depends on neither. Pass
# A's phase walks cost issue slots, passes A and C a lane range of latency
# each, so more lanes of fewer phases win until the slow route grows: on
# the H100 48 x 21 measured fastest of 32 x 32, 48 x 21, 64 x 16 and 128 x
# 8 (lzhuf_lanes.py; PERF.md), its slow route taking 0.1% of the lane
# boundaries (64 x 16: 2.7%). The kernel stages the whole slice up to the
# end-bit hint (one block an SM), which measured faster than staging part
# of it (two).
SPEC_LANES = 48
SPEC_PHASES = 21


def _token_decoder(stream_words, tab):
    """decode(chain, bitpos) -> (nbits, nout, marker), int64 tensors: the
    token at bitpos of each segment's slice as the kernel decodes it. A
    table row whose entries all fit 16 bits is read as the kernel stages
    it, narrowed (an escape keeps its level-2 chunk index) and widened
    back. Words ride in int64, so shifts are logical (H2/H3)."""
    NB, SW = stream_words.shape
    s_flat = as_u32(stream_words).reshape(-1)
    t = as_u32(tab)
    esc = (t & 31) == 31
    fits = torch.where(esc, (((t >> 5) & 31) == 0) & ((t >> 10) < 2048),
                       t < (1 << 16)).all(1)
    t16 = torch.where(esc, ((t >> 10) << 5) | 31, t)
    wide = torch.where((t16 & 31) == 31, ((t16 >> 5) << 10) | 31, t16)
    t_flat = torch.where(fits[:, None], wide, t).reshape(-1)

    def decode(chain, bitpos):
        sh = bitpos & 31
        wc = chain * SW + torch.clamp(bitpos >> 5, 0, SW - 3)
        w0, w1, w2 = s_flat[wc], s_flat[wc + 1], s_flat[wc + 2]

        def bits_at(off, n):
            return _bits_at(w0, w1, w2, sh, off, n)

        t_base = chain * TW

        def lookup(l1, l2, off):
            e = t_flat[t_base + l1 + bits_at(off, L1_BITS)]
            e2 = t_flat[t_base + torch.clamp(
                l2 + (e >> 5) + bits_at(off + L1_BITS, 5), max=TW - 1)]
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
        nout = torch.where(is_match, mlen, 1)
        mark = torch.where(is_match,
                           (_KIND_MATCH << 28) | ((pval << 9) & U32) | mlen,
                           (_KIND_LIT << 28) | csym)
        return nbits, nout, mark

    return decode


def _bits_at(w0, w1, w2, sh, off, n):
    """The kernel's bits_at: the 32 bits at sh + off of the 96-bit
    big-endian window (w0, w1, w2) shifted right by (32 - n) & 31 (n bits
    MSB first for n in [1, 32]; a corrupt stream's raw-bit count may pass
    32), or 0 for n == 0."""
    b = sh + off
    wi = b >> 5
    s2 = b & 31
    lo = torch.where(wi == 0, w0, torch.where(wi == 1, w1, w2))
    hi = torch.where(wi == 0, w1, torch.where(wi == 1, w2, 0))
    v = ((lo << s2) & U32) | torch.where(s2 > 0, hi >> (32 - s2), 0)
    if isinstance(n, int):
        return v >> (32 - n)
    return torch.where(n > 0, v >> ((32 - n) & 31), 0)


def _walk_range(decode, chain, x, n, end, cap):
    """The kernel's walk() for many walks at once (1-D int64 tensors): from
    token start x with count n until the next token would start at or
    past `end`, or the count reaches `cap`. Returns (x, n)."""
    while True:
        go = (x < end) & (n < cap)
        if not bool(go.any()):
            return x, n
        nbits, nout, _ = decode(chain, x)
        x = torch.where(go, x + nbits, x)
        n = torch.where(go, n + nout, n)


def lzhuf_walk_spec_plain(stream_words, body_bit_local, out_len, start_pos,
                          tab, walk_end_bit=None, lanes=SPEC_LANES,
                          phases=SPEC_PHASES):
    """The kernel's torch twin (csrc/lzhuf_walk.cu), vectorised over
    segments, lanes and phases: pass A (phase walk d of lane k from bit
    g_k + d to the lane's range end), the stitch in lane order (a lookup
    where the true walk enters lane k within `phases` bits of g_k, the
    slow route's walk through the range otherwise) and pass C (each lane
    stores its range from its true entry). Arguments as lzhuf_walk.
    Returns (markers [NB, BLOCK] int32, equal to lzhuf_walk_plain's for
    any lanes, phases and hint; [lane boundaries resolved by a phase
    walk, walked by the slow route, the largest entry offset past a
    guess], as the kernel counts them)."""
    NB, SW = stream_words.shape
    dev = stream_words.device
    L, D = lanes, phases
    i64 = torch.int64
    decode = _token_decoder(stream_words, tab)
    olen = torch.clamp(out_len.to(i64), max=BLOCK)
    start = start_pos.to(i64)
    cap = olen - start
    live = start < olen
    lo = body_bit_local.to(i64)
    hi = torch.full_like(lo, SW * 32)
    if walk_end_bit is not None:
        h = walk_end_bit.to(i64)
        hi = torch.where((h > lo) & (h <= hi), h, hi)
    span = torch.clamp(hi - lo, min=0)
    k = torch.arange(L, device=dev, dtype=i64)
    g = torch.cat([lo[:, None] + span[:, None] * k // L,
                   torch.maximum(hi, lo)[:, None]], dim=1)   # [NB, L + 1]

    # Pass A over [NB, L, D] phase walks (segments that hold no output
    # walk nothing).
    d = torch.arange(D, device=dev, dtype=i64)
    chain = torch.arange(NB, device=dev, dtype=i64)[:, None, None].expand(
        NB, L, D).reshape(-1)
    x0 = (g[:, :L, None] + d).reshape(-1)
    end = torch.where(live[:, None, None], g[:, 1:, None],
                      -1).expand(NB, L, D).reshape(-1)
    wex, wcnt = _walk_range(decode, chain, x0, torch.zeros_like(x0), end,
                            cap[:, None, None].expand(NB, L, D).reshape(-1))
    wex, wcnt = wex.reshape(NB, L, D), wcnt.reshape(NB, L, D)

    # The stitch, lane by lane, over the segments at once.
    rows = torch.arange(NB, device=dev)
    T = torch.zeros((NB, L), dtype=i64, device=dev)
    O = torch.zeros((NB, L), dtype=i64, device=dev)
    own = torch.zeros((NB, L), dtype=torch.bool, device=dev)
    x, o, alive = lo.clone(), torch.zeros_like(lo), live.clone()
    n_direct = n_serial = far = 0
    for j in range(L):
        own[:, j] = alive
        T[:, j] = x
        O[:, j] = o
        off = x - g[:, j]
        direct = alive & (off >= 0) & (off < D)
        slow = alive & ~direct
        if bool(alive.any()):
            far = max(far, int(off[alive].max()))
        n_direct += int(direct.sum())
        n_serial += int(slow.sum())
        dj = off.clamp(0, D - 1)
        n = torch.where(direct, o + wcnt[rows, j, dj], o)
        x = torch.where(direct, wex[rows, j, dj], x)
        if bool(slow.any()):
            xs, ns = _walk_range(decode, rows, x, n,
                                 torch.where(slow, g[:, j + 1], -1), cap)
            x = torch.where(slow, xs, x)
            n = torch.where(slow, ns, n)
        o = torch.where(alive, n, o)
        alive = alive & (o < cap)

    # Pass C, over [NB * L] lanes.
    out = torch.zeros(NB * (BLOCK + 1), dtype=torch.int32, device=dev)
    chain = torch.arange(NB, device=dev, dtype=i64).repeat_interleave(L)
    endc = g[:, 1:].clone()
    endc[:, -1] = 1 << 62
    endc = endc.reshape(-1)
    x = T.reshape(-1)
    pos = (start[:, None] + O).reshape(-1)
    olenf = olen.repeat_interleave(L)
    going = own.reshape(-1)
    while True:
        going = going & (x < endc) & (pos < olenf)
        if not bool(going.any()):
            break
        nbits, nout, mark = decode(chain, x)
        col = torch.where(going, chain * (BLOCK + 1) + pos,
                          chain * (BLOCK + 1) + BLOCK)
        out[col] = torch.where(going, mark, 0).to(torch.int32)
        x = torch.where(going, x + nbits, x)
        pos = torch.where(going, pos + nout, pos)
    return (out.reshape(NB, BLOCK + 1)[:, :BLOCK],
            [n_direct, n_serial, far])


def shared_bytes(sw: int = SLICE_BYTES // 4, lanes=None,
                 phases=None) -> int:
    """The token walk kernel's dynamic shared memory at slices of sw
    words: 16-bit tables, the staged slice, the phase walks' exits and
    counts, the lanes' state (lanes and phases the module's own where not
    given)."""
    L = SPEC_LANES if lanes is None else lanes
    D = SPEC_PHASES if phases is None else phases
    return 2 * TW + 4 * sw + 8 * L * D + 4 * (4 * L + 1)


def occupancy(sw: int = SLICE_BYTES // 4) -> int:
    """Blocks of the token walk kernel resident per SM on the current
    card at slices of sw words (0 where the configuration does not
    fit)."""
    from tpz_torch.kernels import _build

    return _build.lib().tpz_lzhuf_walk_occupancy(SPEC_LANES, SPEC_PHASES,
                                                  sw)


def lzhuf_walk(stream_words, body_bit_local, out_len, start_pos, tab,
               walk_end_bit=None):
    """The token walk: the plain version for CPU tensors, the CUDA kernel
    (csrc/lzhuf_walk.cu: SPEC_LANES lanes a segment, each walked from
    SPEC_PHASES bits at its guess, stitched by lookup, then storing) for
    CUDA tensors. Arguments as lzhuf_walk_plain; all int32 and
    contiguous. walk_end_bit [NB] int32 (optional) is each segment's end
    bit, slice-local: a hint where to put the guesses and how much of the
    slice to stage, on which the result does not depend; the plain
    version ignores it. After a launch, lzhuf_walk.last_stats holds, on
    the card, [lane boundaries resolved by a phase walk, walked by the
    slow route, the largest entry offset past a guess]."""
    args = (stream_words, body_bit_local, out_len, start_pos, tab)
    if stream_words.device.type == "cpu":
        return lzhuf_walk_plain(*args)
    if stream_words.device.type != "cuda":
        raise ValueError(f"lzhuf walk: unsupported device "
                         f"{stream_words.device}")
    NB, SW = stream_words.shape
    shapes = ((NB, SW), (NB,), (NB,), (NB,), (NB, TW), (NB,))
    names = ("stream_words", "body_bit_local", "out_len", "start_pos", "tab",
             "walk_end_bit")
    checked = args if walk_end_bit is None else args + (walk_end_bit,)
    for name, t, shape in zip(names, checked, shapes):
        if (t.device != stream_words.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"lzhuf walk: {name} must be a contiguous int32 tensor of "
                f"shape {shape} on {stream_words.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if SW < 3:
        raise ValueError(f"lzhuf walk: slices of {SW} words, need >= 3")
    if not (SPEC_LANES >= 1 and SPEC_PHASES >= 1
            and SPEC_LANES * SPEC_PHASES <= 1024):
        raise ValueError(f"lzhuf walk: SPEC_LANES={SPEC_LANES} x "
                         f"SPEC_PHASES={SPEC_PHASES} threads outside [1, "
                         f"1024]")
    need = shared_bytes(SW)
    if need > SHARED_LIMIT:
        raise ValueError(f"lzhuf walk: {need} bytes of shared memory; a "
                         f"CUDA block holds at most {SHARED_LIMIT}")
    # The kernel writes every position of the row.
    out = torch.empty((NB, BLOCK), dtype=torch.int32,
                      device=stream_words.device)
    stats = torch.zeros(3, dtype=torch.int32, device=stream_words.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(stream_words.device):
        rc = _build.lib().tpz_lzhuf_walk(
            *(t.data_ptr() for t in args),
            None if walk_end_bit is None else walk_end_bit.data_ptr(),
            out.data_ptr(), stats.data_ptr(), NB, SW, SPEC_LANES,
            SPEC_PHASES, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lzhuf walk kernel launch failed: cudaError {rc}")
    lzhuf_walk.launches += 1
    lzhuf_walk.last_stats = stats
    return out


lzhuf_walk.launches = 0
lzhuf_walk.kernels = ("lzhuf_walk_kernel",)
lzhuf_walk.last_stats = None


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
    with stage("lzhuf", "walk", stage_hook):
        markers = lzhuf_walk(*_walk_args(t), walk_end_bit=t["walk_end_bit"])
    with stage("lzhuf", "materialize", stage_hook):
        dense = _dense_markers(markers, t)
    with stage("lzhuf", "resolve", stage_hook):
        return resolve_dense(dense, dist_bias=1)


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
         for k in ("body_bit_local", "out_len", "carry_len", "carry",
                   "walk_end_bit")}
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
        # The walk's end-bit hint: each segment's end, slice-local.
        L["walk_end_bit"][sl] = idx["end_bits"] - idx["seg_bits"] // 8 * 8
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
    with stage("lzhuf", "index", stage_hook):
        for i, (data, orig_size) in enumerate(items):
            if orig_size == 0:
                results[i] = b""
                continue
            idx = (oracle.lzhuf_index(data, orig_size, dict_bits,
                                      seg_out=BLOCK)
                   if orig_size <= MAX_STREAM else None)
            if idx is None or len(idx["out_lens"]) == 0:
                results[i] = _host_decode(data, orig_size, dict_bits)
                continue
            spans = (idx["end_bits"] + 7) // 8 + 1 - idx["seg_bits"] // 8
            if int(spans.max()) > SLICE_BYTES:
                results[i] = _host_decode(data, orig_size, dict_bits)
                continue
            cand.append((i, idx, spans))
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
    with stage("lzhuf", "tables", stage_hook):
        np_ = oracle._lzhuf_np(dict_bits)
        entries, kept = [], []
        for i, idx, spans in cand:
            rows = _segment_tables(idx, np_)
            if rows is None:
                results[i] = _host_decode(items[i][0], items[i][1],
                                          dict_bits)
                continue
            entries.append((items[i][0], idx, spans, rows))
            kept.append(i)
    if not kept:
        return
    with stage("lzhuf", "layout", stage_hook):
        layout = _layout(entries)
    with stage("lzhuf", "h2d", stage_hook):
        t = _to_device(layout, device)
    out = _decode(t, stage_hook)
    with stage("lzhuf", "fetch", stage_hook):
        flat = out.cpu().numpy()
        pos = 0
        for i in kept:
            n_out = items[i][1]
            results[i] = flat[pos:pos + n_out].tobytes()
            pos += n_out
