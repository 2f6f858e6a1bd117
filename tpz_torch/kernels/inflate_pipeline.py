"""Batched DEFLATE decode on one torch device (port of
tpz/kernels/inflate_pipeline.py).

DEFLATE decode is bit-serial, so parallel decode needs to know where each
piece of the stream starts. Two routes give that:
  indexed     the encoder's 'TZ' gzip side-car lists every 64 KiB block's
              end bit; the host header scan (cpp InflateScanHeaders)
              reads only the block headers and builds decode tables.
  segmented   any stream (foreign gzip/zlib/raw): the host segment
              indexer (cpp InflateIndex) token-walks the stream once and
              cuts it into <= 64 KiB-output segments, with split-match
              carries; the segment scan builds their tables.
Then, on the device, stage by stage (each the span
tpz_torch.inflate.<name>; the names `stage_hook` receives):
  scan         (host) header or segment scan and the slice layout; on the
               segmented route after the segment index (index_stream,
               span inflate.index)
  h2d          the layout copied to the device
  walk         symbol walk: every entry's Huffman stream decoded in
               parallel into markers [NB, BLOCK] (CUDA kernel on a card)
  materialize  stored-block bytes, dead-tail blanking, carry markers; on
               the segmented route also the placement into dense output
  resolve      LZ77 copy machine over the dense markers (resolve_walk)
  fetch        device-to-host copy, cut per stream
The callers check CRC-32 or Adler-32 on the result. Each device batch,
from its slice layout to its fetch, is one span inflate.batch.

The reference declines two shapes to the host inflate: a valid tree that
overflows the decode tables' L2 (`lit_bits < 0`), and a stream the
segment indexer refuses. The port keeps those declines, counts each in
`host_declines`, and decodes those streams with the C++ inflate.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch import constants as C
from tpz_torch import errors, oracle
from tpz_torch.kernels._build import SHARED_LIMIT
from tpz_torch.kernels.deflate_pipeline import _device
# Marker layout (resolve_walk's docstring): kind << 28 | payload, with
# payload = byte for _KIND_LIT and dist << 9 | len for _KIND_MATCH.
from tpz_torch.kernels.resolve_walk import (_KIND_LIT, _KIND_MATCH,
                                            resolve_dense)
from tpz_torch.utils.bits import U32, as_u32
from tpz_torch.utils.profiling import _nohook, span, stage

BLOCK = 65536
# Per-entry stream slice: an encoder block needs ~64 KiB plus its header;
# a segment of a foreign stream may run a few KiB past that before its
# producer would have switched to a stored block.
SLICE_BYTES = BLOCK + 8192

# One packed-state resolve (index << 8 | byte in 32 bits) covers 2^24
# output bytes: a batch above it splits into groups. A single stream above
# it is dispatched alone (resolve_dense chains it through halos), up to
# MAX_DECODE_SPAN_WIDE.
MAX_DECODE_SPAN = 1 << 24
MAX_DECODE_SPAN_WIDE = 1 << 27

TAB_WIDTH = C.INFLATE_LIT_TW + C.INFLATE_DIST_TW

# Streams handed to the host inflate because the device path declined
# their shape (see the module docstring).
host_declines = 0


def _host_inflate(stream: bytes) -> tuple[bytes, int]:
    global host_declines
    host_declines += 1
    with span("inflate.host_decline"):
        return oracle.inflate(stream)


# ----------------------------------------------------------- symbol walk

def symbol_walk_plain(stream_words, body_bit_local, out_len, tab, len_base,
                      len_extra, dist_base, dist_extra, start_pos):
    """The plain version of the symbol walk (the reference's lane-parallel
    _symbol_walk_vz): every entry advances one token per loop trip, so
    the trip count is the largest token count of any entry.

    stream_words [NB, SW] int32 (LE u32 words of each entry's slice);
    body_bit_local, out_len, start_pos [NB] int32; tab [NB, TAB_WIDTH]
    int32, the fused [lit L1 | lit L2 | dist L1 | dist L2] tables;
    len_base, len_extra [29], dist_base, dist_extra [30] int32. Returns
    markers [NB, BLOCK] int32: one at each token's output position, 0
    elsewhere. Stream words ride in int64 so shifts are logical (H2/H3)."""
    NB, SW = stream_words.shape
    TW = tab.shape[1]
    dev = stream_words.device
    L1B = C.INFLATE_L1_BITS
    L1M = (1 << L1B) - 1
    OLIT2 = 1 << L1B
    ODIST1 = C.INFLATE_LIT_TW
    ODIST2 = ODIST1 + (1 << L1B)
    s_flat = as_u32(stream_words).reshape(-1)
    t_flat = as_u32(tab).reshape(-1)
    lb, le, db, de = (x.to(torch.int64) for x in (len_base, len_extra,
                                                   dist_base, dist_extra))
    seg = torch.arange(NB, device=dev, dtype=torch.int64)
    s_base = seg * SW
    t_base = seg * TW
    o_base = seg * (BLOCK + 1)
    ol = out_len.to(torch.int64)
    bitpos = body_bit_local.to(torch.int64)
    out_pos = start_pos.to(torch.int64)
    ok = torch.ones(NB, dtype=torch.bool, device=dev)
    # Column BLOCK takes the writes of finished entries.
    out = torch.zeros(NB * (BLOCK + 1), dtype=torch.int32, device=dev)

    trip = 0
    while trip % 16 or bool((ok & (out_pos < ol)).any()):
        trip += 1
        act = ok & (out_pos < ol)
        sh = bitpos & 31
        wc = s_base + torch.clamp(bitpos >> 5, 0, SW - 3)
        w0, w1, w2 = s_flat[wc], s_flat[wc + 1], s_flat[wc + 2]
        # Bits [sh, sh + 64) of the 96-bit window (w0, w1, w2) in one int64
        # (an int64 shift by 32 is defined: it gives 0 after the mask). A
        # token reads at most 48 bits past sh, and a field of n <= 15 bits
        # at offset off <= 48 ends below bit 63, so the sign bit that the
        # top word may set never reaches a field.
        lo = ((w0 >> sh) | (w1 << (32 - sh))) & U32
        hi = ((w1 >> sh) | (w2 << (32 - sh))) & U32
        win = lo | (hi << 32)

        def bits_at(off, n):
            return (win >> off) & ((1 << n) - 1)

        peek = bits_at(0, 15)
        e1 = t_flat[t_base + (peek & L1M)]
        e1b = t_flat[t_base + torch.clamp(
            OLIT2 + (e1 >> 5) + ((peek >> L1B) & 31), max=TW - 1)]
        e = torch.where((e1 & 31) == 31, e1b, e1)
        clen = e & 31
        sym = e >> 5
        okn = ok & (clen > 0) & (sym != 256) & (sym <= 285)

        is_match = sym > 256
        li = torch.clamp(sym - 257, 0, 28)
        eb = le[li]
        lval = lb[li] + bits_at(clen, eb)
        pk = bits_at(clen + eb, 15)
        d1 = t_flat[t_base + ODIST1 + (pk & L1M)]
        d1b = t_flat[t_base + torch.clamp(
            ODIST2 + (d1 >> 5) + ((pk >> L1B) & 31), max=TW - 1)]
        e2 = torch.where((d1 & 31) == 31, d1b, d1)
        dlen = e2 & 31
        ds = torch.clamp(e2 >> 5, 0, 29)
        okn = okn & (~is_match | (dlen > 0))
        deb = de[ds]
        dval = db[ds] + bits_at(clen + eb + dlen, deb)

        nbits = torch.where(is_match, clen + eb + dlen + deb, clen)
        adv = torch.where(is_match, lval, 1)
        mark = torch.where(is_match, (_KIND_MATCH << 28) | (dval << 9) | lval,
                           (_KIND_LIT << 28) | sym)
        mark = torch.where(okn, mark, 0)
        adv = torch.where(okn, adv, BLOCK)  # corrupt stream: abort the entry

        col = torch.where(act, out_pos, BLOCK)
        out.index_put_((o_base + col,), mark.to(torch.int32))
        bitpos = torch.where(act, bitpos + nbits, bitpos)
        out_pos = torch.where(act, out_pos + adv, out_pos)
        ok = torch.where(act, okn, ok)
    return out.reshape(NB, BLOCK + 1)[:, :BLOCK]


# The speculative walk (csrc/symbol_walk.cu): lanes a chain (at most 256),
# and token starts each lane records for the stitch (E, at most 64). The
# result depends on neither; E bounds how late a lane may fall into step
# with the true walk before its boundary takes the slow route.
SPEC_LANES = 128
SPEC_RECORDS = 8

_MET, _THROUGH, _ENDED, _NONE = range(4)
_RANGE, _INVALID, _CAP = range(3)


def _token_decoder(stream_words, tab, len_base, len_extra, dist_base,
                   dist_extra):
    """decode(chain, bitpos) -> (ok, nbits, nout, marker), int64 tensors:
    the token at bitpos of each chain's slice, as the serial walk decodes
    it (ok false for an invalid symbol or distance code, or symbol 256)."""
    NB, SW = stream_words.shape
    TW = tab.shape[1]
    L1B = C.INFLATE_L1_BITS
    L1M = (1 << L1B) - 1
    ODIST1 = C.INFLATE_LIT_TW
    s_flat = as_u32(stream_words).reshape(-1)
    t_flat = as_u32(tab).reshape(-1)
    lb, le, db, de = (x.to(torch.int64) for x in (len_base, len_extra,
                                                   dist_base, dist_extra))

    def decode(chain, bitpos):
        sh = bitpos & 31
        wc = chain * SW + torch.clamp(bitpos >> 5, 0, SW - 3)
        w0, w1, w2 = s_flat[wc], s_flat[wc + 1], s_flat[wc + 2]
        lo = ((w0 >> sh) | (w1 << (32 - sh))) & U32
        hi = ((w1 >> sh) | (w2 << (32 - sh))) & U32
        win = lo | (hi << 32)

        def bits_at(off, n):
            return (win >> off) & ((1 << n) - 1)

        t_base = chain * TW
        peek = bits_at(0, 15)
        e1 = t_flat[t_base + (peek & L1M)]
        e1b = t_flat[t_base + torch.clamp(
            (1 << L1B) + (e1 >> 5) + ((peek >> L1B) & 31), max=TW - 1)]
        e = torch.where((e1 & 31) == 31, e1b, e1)
        clen = e & 31
        sym = e >> 5
        ok = (clen > 0) & (sym != 256) & (sym <= 285)
        is_match = sym > 256
        li = torch.clamp(sym - 257, 0, 28)
        eb = le[li]
        lval = lb[li] + bits_at(clen, eb)
        pk = bits_at(clen + eb, 15)
        d1 = t_flat[t_base + ODIST1 + (pk & L1M)]
        d1b = t_flat[t_base + torch.clamp(
            ODIST1 + (1 << L1B) + (d1 >> 5) + ((pk >> L1B) & 31), max=TW - 1)]
        e2 = torch.where((d1 & 31) == 31, d1b, d1)
        dlen = e2 & 31
        ds = torch.clamp(e2 >> 5, 0, 29)
        ok = ok & (~is_match | (dlen > 0))
        deb = de[ds]
        dval = db[ds] + bits_at(clen + eb + dlen, deb)
        nbits = torch.where(is_match, clen + eb + dlen + deb, clen)
        nout = torch.where(is_match, lval, 1)
        mark = torch.where(is_match, (_KIND_MATCH << 28) | (dval << 9) | lval,
                           (_KIND_LIT << 28) | sym)
        return ok, nbits, nout, mark

    return decode


def _carry(decode, chain, x, c, i, rbit, nrec, end, cap):
    """The kernel's carry() for many walks at once (1-D int64 tensors;
    rbit [n, E] the lanes' recorded starts, padded with a bit past every
    walk): walks at token starts x with counts c go on into a lane's range
    against its records from index i, until they meet one, reach the
    range's end or end. Returns (kind, x, c, i)."""
    kind = torch.full_like(x, -1)
    pad = torch.full_like(rbit[:, :1], 1 << 62)
    rb = torch.cat([rbit, pad], dim=1)
    while True:
        live = kind < 0
        if not bool(live.any()):
            return kind, x, c, i
        i = torch.maximum(i, (rbit < x[:, None]).sum(1))
        met = (i < nrec) & (rb.gather(1, i[:, None])[:, 0] == x)
        ok, nbits, nout, _ = decode(chain, x)
        for cond, k in ((x >= end, _THROUGH), (met, _MET), (c >= cap, _ENDED),
                        (~ok, _ENDED)):
            kind = torch.where((kind < 0) & live & cond, k, kind)
        step = live & (kind < 0)
        x = torch.where(step, x + nbits, x)
        c = torch.where(step, c + nout, c)


def symbol_walk_spec_plain(stream_words, body_bit_local, out_len, tab,
                           len_base, len_extra, dist_base, dist_extra,
                           start_pos, walk_end_bit=None,
                           lanes=SPEC_LANES, records=SPEC_RECORDS):
    """The kernel's torch twin (csrc/symbol_walk.cu), vectorised over
    chains and lanes: pass A (each lane decodes from its guess, recording
    its first `records` token starts), pass B (lane k - 1 goes on into
    lane k's range until the two meet), the stitch in lane order with its
    slow route, and pass C (each lane stores its confirmed range).
    Arguments as symbol_walk. Returns (markers [NB, BLOCK] int32, equal to
    symbol_walk_plain's for any lanes, records and hint; [lane boundaries
    met in pass B, carried through in pass B without meeting, re-walked
    in the stitch], as the kernel counts them)."""
    NB, SW = stream_words.shape
    dev = stream_words.device
    L, E = lanes, records
    decode = _token_decoder(stream_words, tab, len_base, len_extra,
                            dist_base, dist_extra)
    i64 = torch.int64
    olen = torch.clamp(out_len.to(i64), max=BLOCK)
    start = start_pos.to(i64)
    cap = olen - start
    live_chain = start < olen
    lo = body_bit_local.to(i64)
    hi = torch.full_like(lo, SW * 32)
    if walk_end_bit is not None:
        h = walk_end_bit.to(i64)
        hi = torch.where((h > lo) & (h <= hi), h, hi)
    span = torch.clamp(hi - lo, min=0)
    k = torch.arange(L, device=dev, dtype=i64)
    g = torch.cat([lo[:, None] + span[:, None] * k // L,
                   torch.maximum(hi, lo)[:, None]], dim=1)   # [NB, L + 1]
    big = 1 << 62

    # Pass A, over [NB * L] lanes.
    chain = torch.arange(NB, device=dev, dtype=i64).repeat_interleave(L)
    end = g[:, 1:].reshape(-1)
    capf = cap.repeat_interleave(L)
    x = g[:, :-1].reshape(-1).clone()
    n = torch.zeros_like(x)
    r = torch.zeros_like(x)
    why = torch.full_like(x, _RANGE)
    going = live_chain.repeat_interleave(L).clone()
    rbit = torch.full((NB * L, E), big, dtype=i64, device=dev)
    rcnt = torch.zeros((NB * L, E), dtype=i64, device=dev)
    rows = torch.arange(NB * L, device=dev)
    while True:
        going = going & (x < end)
        full = going & (n >= capf)
        why = torch.where(full, _CAP, why)
        going = going & ~full
        if not bool(going.any()):
            break
        ok, nbits, nout, _ = decode(chain, x)
        why = torch.where(going & ~ok, _INVALID, why)
        going = going & ok
        rec = going & (r < E)
        col = torch.where(rec, r, 0)
        rbit[rows, col] = torch.where(rec, x, rbit[rows, col])
        rcnt[rows, col] = torch.where(rec, n, rcnt[rows, col])
        r = torch.where(rec, r + 1, r)
        x = torch.where(going, x + nbits, x)
        n = torch.where(going, n + nout, n)
    ex, cnt, nrec = (t.reshape(NB, L) for t in (x, n, r))
    stop = why.reshape(NB, L)
    rbit3 = rbit.reshape(NB, L, E)
    rcnt3 = rcnt.reshape(NB, L, E)

    # Pass B: lane j - 1 into lane j, for j = 1 .. L - 1.
    bkind = torch.full((NB, L), _NONE, dtype=i64, device=dev)
    bx, bc, bi = (torch.zeros((NB, L), dtype=i64, device=dev)
                  for _ in range(3))
    if L > 1:
        ch2 = torch.arange(NB, device=dev, dtype=i64).repeat_interleave(L - 1)
        run = (stop[:, :-1] == _RANGE).reshape(-1)
        zero = torch.zeros(NB * (L - 1), dtype=i64, device=dev)
        kind, x, n, i = _carry(
            decode, ch2, ex[:, :-1].reshape(-1), zero, zero,
            rbit3[:, 1:].reshape(-1, E), nrec[:, 1:].reshape(-1),
            torch.where(run, g[:, 2:].reshape(-1), -big),
            cap.repeat_interleave(L - 1))
        bkind[:, 1:] = torch.where(run, kind, _NONE).reshape(NB, L - 1)
        bx[:, 1:], bc[:, 1:], bi[:, 1:] = (
            t.reshape(NB, L - 1) for t in (x, n, i))

    # The stitch, lane by lane, over the chains at once.
    chains = torch.arange(NB, device=dev, dtype=i64)
    T = torch.zeros((NB, L), dtype=i64, device=dev)
    O = torch.zeros((NB, L), dtype=i64, device=dev)
    own = torch.zeros((NB, L), dtype=torch.bool, device=dev)
    T[:, 0] = lo
    own[:, 0] = live_chain
    x, o = ex[:, 0].clone(), cnt[:, 0].clone()
    alive = live_chain & (stop[:, 0] == _RANGE) & (o < cap)
    n_met = n_through = n_serial = 0
    for j in range(1, L):
        own[:, j] = alive
        T[:, j] = x
        O[:, j] = o
        fast = alive & (x == ex[:, j - 1]) & (bkind[:, j] != _NONE)
        slow = alive & ~fast
        n_met += int((fast & (bkind[:, j] == _MET)).sum())
        n_through += int((fast & (bkind[:, j] != _MET)).sum())
        n_serial += int(slow.sum())
        kind = torch.where(fast, bkind[:, j], -1)
        n = torch.where(fast, o + bc[:, j], o)
        i = torch.where(fast, bi[:, j], 0)
        x = torch.where(fast, bx[:, j], x)
        end_j = g[:, j + 1]
        if bool(slow.any()):
            kk, xx, nn, ii = _carry(decode, chains, x, n, i * 0, rbit3[:, j],
                                    nrec[:, j],
                                    torch.where(slow, end_j, -big), cap)
            kind = torch.where(slow, kk, kind)
            x, n, i = (torch.where(slow, a, b)
                       for a, b in ((xx, x), (nn, n), (ii, i)))
        met = alive & (kind == _MET)
        got = rcnt3[:, j].gather(1, torch.clamp(i, max=E - 1)[:, None])[:, 0]
        n = torch.where(met, n + cnt[:, j] - got, n)
        x = torch.where(met, ex[:, j], x)
        ends = met & (stop[:, j] == _INVALID)
        more = met & (stop[:, j] == _CAP) & (n < cap)
        if bool(more.any()):
            kk, xx, nn, _ = _carry(decode, chains, x, n, nrec[:, j],
                                   rbit3[:, j], nrec[:, j],
                                   torch.where(more, end_j, -big), cap)
            kind = torch.where(more, kk, kind)
            x = torch.where(more, xx, x)
            n = torch.where(more, nn, n)
        alive = alive & ~ends & ~(kind == _ENDED)
        o = torch.where(own[:, j], n, o)
        alive = alive & (o < cap)

    # Pass C, over [NB * L] lanes.
    out = torch.zeros(NB * (BLOCK + 1), dtype=torch.int32, device=dev)
    endc = g[:, 1:].clone()
    endc[:, -1] = big
    endc = endc.reshape(-1)
    x = T.reshape(-1)
    pos = (start[:, None] + O).reshape(-1)
    olenf = olen.repeat_interleave(L)
    going = own.reshape(-1).clone()
    while True:
        going = going & (x < endc) & (pos < olenf)
        if not bool(going.any()):
            break
        ok, nbits, nout, mark = decode(chain, x)
        going = going & ok
        col = torch.where(going, chain * (BLOCK + 1) + pos,
                          chain * (BLOCK + 1) + BLOCK)
        out[col] = torch.where(going, mark, 0).to(torch.int32)
        x = torch.where(going, x + nbits, x)
        pos = torch.where(going, pos + nout, pos)
    markers = out.reshape(NB, BLOCK + 1)[:, :BLOCK]
    return markers, [n_met, n_through, n_serial]


def symbol_walk_shared_bytes(SW: int, lanes: int = SPEC_LANES,
                             records: int = SPEC_RECORDS) -> int:
    """The symbol walk kernel's dynamic shared memory: a chain's tables,
    its stream slice of SW words and the lanes' records."""
    return 4 * (TAB_WIDTH + SW + 2 * lanes * records)


def symbol_walk(stream_words, body_bit_local, out_len, tab, len_base,
                len_extra, dist_base, dist_extra, start_pos,
                walk_end_bit=None):
    """The symbol walk: the plain version for CPU tensors, the CUDA kernel
    (csrc/symbol_walk.cu: a warp a chain decoding from guessed bit
    offsets, stitched, then emitting) for CUDA tensors. Arguments as
    symbol_walk_plain; all int32 and contiguous. walk_end_bit [NB] int32
    (optional) is each chain's end bit, slice-local: a hint where to put
    the guesses, on which the result does not depend; the plain version
    ignores it. After a launch, symbol_walk.last_stats holds, on the
    card, [lane boundaries met in pass B, carried through in pass B
    without meeting (the slow route), re-walked in the stitch]."""
    args = (stream_words, body_bit_local, out_len, tab, len_base, len_extra,
            dist_base, dist_extra, start_pos)
    if stream_words.device.type == "cpu":
        return symbol_walk_plain(*args)
    if stream_words.device.type != "cuda":
        raise ValueError(f"symbol walk: unsupported device "
                         f"{stream_words.device}")
    NB, SW = stream_words.shape
    shapes = ((NB, SW), (NB,), (NB,), (NB, TAB_WIDTH), (29,), (29,), (30,),
              (30,), (NB,), (NB,))
    names = ("stream_words", "body_bit_local", "out_len", "tab", "len_base",
             "len_extra", "dist_base", "dist_extra", "start_pos",
             "walk_end_bit")
    checked = args if walk_end_bit is None else args + (walk_end_bit,)
    for name, t, shape in zip(names, checked, shapes):
        if (t.device != stream_words.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"symbol walk: {name} must be a contiguous int32 tensor of "
                f"shape {shape} on {stream_words.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if SW < 3:
        raise ValueError(f"symbol walk: slices of {SW} words, need >= 3")
    if not (1 <= SPEC_RECORDS <= 64 and 1 <= SPEC_LANES <= 256):
        raise ValueError(f"symbol walk: SPEC_LANES={SPEC_LANES} and "
                         f"SPEC_RECORDS={SPEC_RECORDS} outside [1, 256] "
                         "and [1, 64]")
    need = symbol_walk_shared_bytes(SW)
    if need > SHARED_LIMIT:
        raise ValueError(f"symbol walk: slices of {SW} words need {need} "
                         f"bytes of shared memory; a CUDA block holds at "
                         f"most {SHARED_LIMIT}")
    out = torch.zeros((NB, BLOCK), dtype=torch.int32,
                      device=stream_words.device)
    stats = torch.zeros(3, dtype=torch.int32, device=stream_words.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(stream_words.device):
        rc = _build.lib().tpz_symbol_walk(
            *(t.data_ptr() for t in args),
            None if walk_end_bit is None else walk_end_bit.data_ptr(),
            out.data_ptr(), stats.data_ptr(), NB, SW, TAB_WIDTH,
            C.INFLATE_LIT_TW, SPEC_LANES, SPEC_RECORDS,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"symbol walk kernel launch failed: cudaError {rc}")
    symbol_walk.launches += 1
    symbol_walk.last_stats = stats
    return out


symbol_walk.launches = 0
symbol_walk.kernels = ("symbol_walk_kernel",)
symbol_walk.last_stats = None


# ------------------------------------------------------- device stages

def _materialize_fn(markers, stream_words, btype, c0_pos_l, c0_len,
                    c1_pos_l, out_len, carry=None):
    """Stored-block byte fill, dead-tail blanking and (segmented route)
    carry-marker synthesis. markers [NB, BLOCK]; stream_words [NB, SW]
    int32; the *_l offsets are local to each slice; carry [NB] int32
    (dist << 9 | len, 0 = none). Returns [NB, BLOCK] int32."""
    pos = torch.arange(BLOCK, device=markers.device,
                       dtype=torch.int64)[None, :]

    # Stored blocks: every position is a literal taken from the slice, from
    # its first chunk and then its second.
    stored = btype == 0
    c0 = c0_len[stored].to(torch.int64)[:, None]
    in_local = torch.where(
        pos < c0, c0_pos_l[stored].to(torch.int64)[:, None] + pos,
        c1_pos_l[stored].to(torch.int64)[:, None] + (pos - c0))
    in_local = torch.clamp(in_local, 0, SLICE_BYTES - 1)
    word = torch.gather(stream_words[stored], 1, in_local >> 2)
    sbyte = (as_u32(word) >> ((in_local & 3) << 3)) & 0xFF
    markers = markers.clone()
    markers[stored] = ((_KIND_LIT << 28) | sbyte).to(torch.int32)

    live = pos < out_len.to(torch.int64)[:, None]
    markers = torch.where(live, markers, _KIND_LIT << 28)

    if carry is not None:
        # A match split across the preceding segment cut re-enters as a
        # match marker at local position 0; the rest of its span reads as
        # blank (the walk never wrote it).
        clen = (carry & 511).to(torch.int64)[:, None]
        cmark = ((_KIND_MATCH << 28) | carry)[:, None]
        markers = torch.where((carry > 0)[:, None] & (pos < clen),
                              torch.where(pos == 0, cmark, 0), markers)
    return markers


def _walk_args(t: dict) -> tuple:
    """The symbol walk's arguments from a device layout."""
    return (t["stream_words"], t["body_bit_local"], t["walk_out_len"],
            t["tab"], t["len_base"], t["len_extra"], t["dist_base"],
            t["dist_extra"], t["start_pos"])


def _materialize_args(t: dict) -> tuple:
    return (t["stream_words"], t["btype"], t["c0_pos_l"], t["c0_len"],
            t["c1_pos_l"], t["out_len"])


def _decode_fused_fn(t: dict, stage_hook=_nohook) -> torch.Tensor:
    """Indexed route: entries are encoder blocks, every one but a stream's
    last exactly BLOCK long, so the [NB, BLOCK] marker space is the dense
    output space. Returns [NB * BLOCK] uint8."""
    with stage("inflate", "walk", stage_hook):
        markers = symbol_walk(*_walk_args(t),
                              walk_end_bit=t["walk_end_bit"])
    with stage("inflate", "materialize", stage_hook):
        markers = _materialize_fn(markers, *_materialize_args(t))
    with stage("inflate", "resolve", stage_hook):
        return resolve_dense(markers.reshape(-1))


def _place_dense(markers, t: dict) -> torch.Tensor:
    """Segmented route: scatter the live marker slots to `dense_off + pos`
    (the keys are unique, so this is the reference's placement sort) and
    pad the dense space with literal markers to a multiple of 128.
    Returns [total_p] int32."""
    total = int(t["out_len"].to(torch.int64).sum())
    total_p = -(-total // 128) * 128
    pos = torch.arange(BLOCK, device=markers.device, dtype=torch.int64)
    live = pos[None, :] < t["out_len"].to(torch.int64)[:, None]
    key = torch.where(live, t["dense_off"][:, None] + pos[None, :], total_p)
    dense = torch.full((total_p + 1,), _KIND_LIT << 28, dtype=torch.int32,
                       device=markers.device)
    dense.index_put_((key.reshape(-1),), markers.reshape(-1))
    return dense[:total_p]


def _decode_segmented_fn(t: dict, stage_hook=_nohook) -> torch.Tensor:
    """Segmented route: entries have ragged out_lens and split-match
    carries; the markers are placed into dense output space before the
    resolve. The reference's power-of-two bucketing of NB and of the dense
    length only bounded XLA recompiles and is not kept. Returns [total]
    uint8."""
    with stage("inflate", "walk", stage_hook):
        markers = symbol_walk(*_walk_args(t),
                              walk_end_bit=t["walk_end_bit"])
    with stage("inflate", "materialize", stage_hook):
        markers = _materialize_fn(markers, *_materialize_args(t),
                                  carry=t["carry"])
        dense = _place_dense(markers, t)
    with stage("inflate", "resolve", stage_hook):
        return resolve_dense(dense)


# ---------------------------------------------------------- host layout

def _len_dist_tables() -> dict:
    return {"len_base": np.asarray(C.DEFLATE_LENGTH_BASE, np.int32),
            "len_extra": np.asarray(C.DEFLATE_LENGTH_EXTRA, np.int32),
            "dist_base": np.asarray(C.DEFLATE_DIST_BASE, np.int32),
            "dist_extra": np.asarray(C.DEFLATE_DIST_EXTRA, np.int32)}


def _layout(entries) -> dict:
    """Host arrays for the device stages. entries: per stream (stream
    bytes, slice start bits [nb], slice end bits [nb], scan dict, out_lens
    [nb], carry_len [nb] or None, carry_dist [nb] or None)."""
    NB = sum(len(e[4]) for e in entries)
    slices = np.zeros((NB, SLICE_BYTES), np.uint8)
    L = {k: np.zeros(NB, np.int32) for k in (
        "body_bit_local", "c0_pos_l", "c0_len", "c1_pos_l", "walk_out_len",
        "out_len", "btype", "start_pos", "carry", "walk_end_bit")}
    tab = np.zeros((NB, TAB_WIDTH), np.int32)
    b0 = 0
    for stream, start_bits, end_bits, scan, out_lens, c_len, c_dist in entries:
        nb = len(out_lens)
        sb = np.frombuffer(stream, np.uint8)
        slice_start = np.asarray(start_bits, np.int64) // 8
        for b in range(nb):
            s0 = int(slice_start[b])
            s1 = min(len(sb), (int(end_bits[b]) + 7) // 8 + 8)
            take = min(s1 - s0, SLICE_BYTES)
            slices[b0 + b, :take] = sb[s0:s0 + take]
        sl = slice(b0, b0 + nb)
        L["body_bit_local"][sl] = scan["body_bit"] - 8 * slice_start
        L["walk_end_bit"][sl] = (np.asarray(end_bits, np.int64)
                                 - 8 * slice_start)
        L["c0_pos_l"][sl] = scan["c0_pos"] - slice_start
        L["c0_len"][sl] = scan["c0_len"]
        L["c1_pos_l"][sl] = scan["c1_pos"] - slice_start
        L["out_len"][sl] = out_lens
        L["walk_out_len"][sl] = np.where(scan["btype"] == 0, 0, out_lens)
        L["btype"][sl] = scan["btype"]
        if c_len is not None:
            cl = np.asarray(c_len, np.int32)
            L["start_pos"][sl] = cl
            L["carry"][sl] = (np.asarray(c_dist, np.int32) << 9) | cl
        tab[sl, :C.INFLATE_LIT_TW] = scan["lit_tab"]
        tab[sl, C.INFLATE_LIT_TW:] = scan["dist_tab"]
        b0 += nb
    L["stream_words"] = slices.view("<u4").view(np.int32)
    L["tab"] = tab
    L.update(_len_dist_tables())
    return L


def _to_device(layout: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in layout.items()}


def _indexed_layout(items, idxs, scans) -> dict:
    entries = []
    for i in idxs:
        stream, end_bits, out_lens = items[i]
        end_bits = np.asarray(end_bits)
        starts = np.concatenate([[0], end_bits[:-1]])
        entries.append((stream, starts, end_bits, scans[i],
                        np.asarray(out_lens), None, None))
    return _layout(entries)


def _segmented_layout(items, idxs, scans) -> dict:
    entries = []
    for i in idxs:
        stream, idx = items[i]
        entries.append((stream, idx["seg_bits"], idx["end_bits"], scans[i],
                        idx["out_lens"], idx["carry_len"], idx["carry_dist"]))
    L = _layout(entries)
    ol = L["out_len"].astype(np.int64)
    L["dense_off"] = np.cumsum(ol) - ol
    return L


# ----------------------------------------------------- host entry points

def _grouped(items, idxs, need, decode, results, _wide):
    """Split a batch whose output passes MAX_DECODE_SPAN into groups under
    it; a single stream above it dispatches alone. Returns True when it
    handled the batch."""
    if _wide or sum(need(i) for i in idxs) <= MAX_DECODE_SPAN:
        return False
    group, group_out = [], 0
    for i in idxs:
        n = need(i)
        if n > MAX_DECODE_SPAN_WIDE:
            raise errors.DataError("stream exceeds MAX_DECODE_SPAN_WIDE")
        if n > MAX_DECODE_SPAN:
            results[i] = decode([items[i]], True)[0]
            continue
        if group and group_out + n > MAX_DECODE_SPAN:
            for gi, out in zip(group, decode([items[g] for g in group],
                                             False)):
                results[gi] = out
            group, group_out = [], 0
        group.append(i)
        group_out += n
    if group:
        for gi, out in zip(group, decode([items[g] for g in group], False)):
            results[gi] = out
    return True


def decompress_indexed(stream: bytes, end_bits, out_lens, device,
                       **kw) -> bytes:
    """Decode one encoder-indexed raw DEFLATE stream on `device`."""
    return decompress_many_indexed([(stream, end_bits, out_lens)], device,
                                   **kw)[0]


def decompress_many_indexed(items, device, *, stage_hook=_nohook,
                            _wide=False):
    """Batch-decode encoder-indexed raw DEFLATE streams; all their blocks
    share one device batch. items: (stream bytes, end_bits, out_lens).
    Match sources never cross stream starts (each stream's window
    resets), so the streams share one flat output space."""
    device = _device(device)
    results = [None] * len(items)
    idxs = []
    for i, (_, end_bits, out_lens) in enumerate(items):
        if len(end_bits) == 0 or int(np.sum(out_lens)) == 0:
            results[i] = b""
            continue
        if np.any(np.asarray(out_lens)[:-1] != BLOCK):
            raise errors.DataError(
                "index block lengths must be 64 KiB except last")
        idxs.append(i)
    if not idxs:
        return results

    def decode(sub, wide):
        return decompress_many_indexed(sub, device, stage_hook=stage_hook,
                                       _wide=wide)

    if _grouped(items, idxs, lambda i: len(items[i][1]) * BLOCK, decode,
                results, _wide):
        return results

    with span("inflate.scan"):
        scans, kept = {}, []
        for i in idxs:
            scan = oracle.inflate_scan_headers(items[i][0],
                                               np.asarray(items[i][1]))
            if (scan["lit_bits"] < 0).any():
                results[i] = _host_inflate(items[i][0])[0]
                continue
            scans[i] = scan
            kept.append(i)
    if not kept:
        return results
    with span("inflate.batch"):
        with stage("inflate", "scan", stage_hook):
            layout = _indexed_layout(items, kept, scans)
        with stage("inflate", "h2d", stage_hook):
            t = _to_device(layout, device)
        out = _decode_fused_fn(t, stage_hook)
        with stage("inflate", "fetch", stage_hook):
            flat = out.cpu().numpy()
            b0 = 0
            for i in kept:
                nb = len(items[i][1])
                # Every block but the last is BLOCK long: the output is
                # contiguous.
                n_out = int(np.sum(items[i][2]))
                results[i] = flat[b0 * BLOCK:b0 * BLOCK + n_out].tobytes()
                b0 += nb
    return results


def index_stream(stream: bytes, seg_out: int = BLOCK):
    """Host segment index over any raw DEFLATE stream (cpp InflateIndex):
    the index dict (with 'consumed' bytes), or None when the stream does
    not fit the device path. seg_out is the output length per segment:
    smaller segments give the walk more, shorter chains. An empty stream
    gives an index with no segments, which decodes to b""."""
    with span("inflate.index"):
        idx = oracle.inflate_index(stream, seg_out=seg_out,
                                   max_span_bytes=SLICE_BYTES - 1024)
    if idx is None or int(np.sum(idx["out_lens"])) > MAX_DECODE_SPAN_WIDE:
        return None
    return idx


def decompress_segmented(stream: bytes, idx: dict, device, **kw) -> bytes:
    """Decode one stream by the segmented route."""
    return decompress_many_segmented([(stream, idx)], device, **kw)[0]


def decompress_many_segmented(items, device, *, stage_hook=_nohook,
                              _wide=False):
    """Batch-decode host-indexed streams (index_stream) in one device
    batch. items: (stream bytes, index dict)."""
    device = _device(device)
    results = [None] * len(items)
    idxs = []
    for i, (_, idx) in enumerate(items):
        if len(idx["out_lens"]) == 0:
            results[i] = b""
        elif int(np.max(idx["out_lens"])) > BLOCK:
            # The [NB, BLOCK] marker space holds at most BLOCK bytes per
            # segment.
            raise errors.DataError("segment out_len exceeds BLOCK")
        else:
            idxs.append(i)
    if not idxs:
        return results

    def decode(sub, wide):
        return decompress_many_segmented(sub, device, stage_hook=stage_hook,
                                         _wide=wide)

    if _grouped(items, idxs, lambda i: int(np.sum(items[i][1]["out_lens"])),
                decode, results, _wide):
        return results

    with span("inflate.scan"):
        scans, kept = {}, []
        for i in idxs:
            stream, idx = items[i]
            scan = oracle.inflate_scan_segments(
                stream, idx["hdr_bits"], idx["seg_bits"], idx["end_bits"])
            if (scan["lit_bits"] < 0).any():
                results[i] = _host_inflate(stream)[0]
                continue
            scans[i] = scan
            kept.append(i)
    if not kept:
        return results
    with span("inflate.batch"):
        with stage("inflate", "scan", stage_hook):
            layout = _segmented_layout(items, kept, scans)
        with stage("inflate", "h2d", stage_hook):
            t = _to_device(layout, device)
        out = _decode_segmented_fn(t, stage_hook)
        with stage("inflate", "fetch", stage_hook):
            flat = out.cpu().numpy()
            pos = 0
            for i in kept:
                n_out = int(np.sum(items[i][1]["out_lens"]))
                results[i] = flat[pos:pos + n_out].tobytes()
                pos += n_out
    return results
