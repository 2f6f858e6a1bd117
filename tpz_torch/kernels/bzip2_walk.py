"""bzip2 block decode on one torch device (port of
tpz/kernels/bzip2_walk.py): the symbol walk, the RLE2 run expansion and
the inverse BWT.

The host header scan (cpp Bzip2ScanHeaders) gives, per block, the bit
offset of its symbol stream, its selectors, its 6 x 258 code lengths and
its initial MTF list. Then:
  walk    the multi-table Huffman decode (table switch every GROUP
          symbols), MTF^-1 and RLE2^-1 into records count << 8 | byte
          (CUDA kernels csrc/bzip2_walk.cu on a card: a records pass a
          block, one thread decoding and a warp running RLE2, into count
          << 8 | rank; then the MTF^-1 in segments of REC_SEG records
          that run in parallel: B1 walks each segment's ranks on the
          identity list of labels, B2 composes the segments' label lists
          into each segment's starting list, B3 maps each label to its
          byte)
  expand  the records run-expanded into each block's BWT last column
          (torch.repeat_interleave)
  sort    the LF-mapping vector of each block (ibwt_walk.ibwt_body)
  ibwt    the inverse BWT walk (CUDA kernel csrc/ibwt_walk.cu on a card)
Each is the span tpz_torch.bzip2.<name> and the name `stage_hook`
receives.

meta[:, 1] (err) is the reference's decline bitmask: 1 a zero-length
code, 2 selectors exhausted, 4 a symbol above end-of-block, 8 a run
accumulator above 2^21, 16 the record cap, stamped with (bitpos + 1) <<
10 of the failing symbol (int32, wrapping); the expansion adds 32 (more
than N bytes) and 64 (orig pointer not below the length), decode 128
(the iBWT flag: the LF map is not one cycle). A block with err != 0 is
declined; its row is decoded with sanitized shapes and discarded.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch.kernels import ibwt_walk
from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.utils.bits import U32, as_u32, to_i32
from tpz_torch.utils.profiling import _nohook, stage

SEL_CAP = 18432
GROUP = 50
# Fused tables per block: 6 x [12-bit level 1 | level-2 chunks], each
# level-2 chunk 32 entries (12 + 5 = 17 bits, the code-length cap) for at
# most 258 escaped prefixes. Entries sym << 5 | len; len 31 escapes to the
# chunk at entry >> 5.
L1_BITS = 12
L1W = 1 << L1_BITS
L2W = 258 * 32
TAB_STRIDE = L1W + L2W
META_WIDTH = 3            # nrec, err, end bitpos
# The walk's arguments, in order, as block_layout names them.
WALK_ARGS = ("n_used", "nsel", "sym_local", "sw", "tab", "selectors",
             "mtf_init")
# Records a segment of the walk's MTF^-1 on a card (bzip2_walk).
REC_SEG = 4096


def build_tables(lens: np.ndarray, n_useds: np.ndarray):
    """lens [NB, 6, 258] uint8 (0 = unused) -> fused tab
    [NB, 6 * TAB_STRIDE] int32 ([t][L1|L2] per table). Canonical MSB
    codes in (len, symbol) order, as cpp/huffman.cc
    BuildDecodeTable(lsb=false)."""
    NB = lens.shape[0]
    tab = np.zeros((NB, 6, TAB_STRIDE), np.int32)
    for b in range(NB):
        alpha = int(n_useds[b]) + 2
        for t in range(6):
            lr = lens[b, t, :alpha].astype(np.int64)
            if not lr.any():
                continue
            order = np.lexsort((np.arange(alpha), lr))
            order = order[lr[order] > 0]
            ls = lr[order]
            # canonical: code of item i = (code_{i-1} + 1) << dlen
            codes = np.zeros(ls.size, np.int64)
            c = 0
            prev = int(ls[0])
            for i in range(ls.size):
                c <<= int(ls[i]) - prev
                prev = int(ls[i])
                codes[i] = c
                c += 1
            l2n = 0
            row1 = tab[b, t, :L1W]
            row2 = tab[b, t, L1W:]
            esc_base = {}
            for i in range(ls.size):
                L = int(ls[i])
                sym = int(order[i])
                code = int(codes[i])
                if L <= L1_BITS:
                    lo = code << (L1_BITS - L)
                    row1[lo:lo + (1 << (L1_BITS - L))] = (sym << 5) | L
                else:
                    pre = code >> (L - L1_BITS)
                    if pre not in esc_base:
                        esc_base[pre] = l2n
                        row1[pre] = (l2n << 5) | 31
                        l2n += 32
                    base = esc_base[pre]
                    suf = code & ((1 << (L - L1_BITS)) - 1)
                    w = 1 << (L1_BITS + 5 - L)
                    s0 = base + (suf << (L1_BITS + 5 - L))
                    row2[s0:s0 + w] = (sym << 5) | L
    return tab.reshape(NB, 6 * TAB_STRIDE)


def rec_cap_for(level: int) -> int:
    """Per-block RLE2 record bound for a stream level: every non-EOB
    symbol emits >= 1 output byte, so records <= block size + 1 <=
    level * 100000 + 1 (+ slack)."""
    return level * 100000 + 16


def records_cap(N: int, rec_cap: int | None = None) -> int:
    """S, the walk's records per block: N + 128, or the 128-rounded
    rec_cap + 128 where that is less (the reference's sizing)."""
    S = N + 128
    if rec_cap is not None:
        S = min(S, -(-(rec_cap + 1) // 128) * 128 + 128)
    return S


# ------------------------------------------------------------- the walk

def bzip2_walk_plain(n_used, nsel, sym_local, sw, tab, selectors, mtf_init,
                     S: int):
    """The plain version of the symbol walk (the reference's
    _walk_kernel.step_chain), every block one step per loop trip, so the
    trip count is the largest symbol count of any block.

    n_used, nsel, sym_local [NB] int32; sw [NB, SW] int32 (big-endian u32
    words of each block's slice, which starts at the byte holding the
    first symbol bit; sym_local is that bit's offset in the byte); tab
    [NB, 6 * TAB_STRIDE] int32 (build_tables); selectors [NB, SEL_CAP]
    uint8; mtf_init [NB, 256] uint8. Returns (recs [NB, S] int32: count
    << 8 | byte, meta [NB, META_WIDTH] int32: records, err, end bitpos).
    Stream words ride in int64, so shifts are logical (H2/H3)."""
    NB, SW = sw.shape
    dev = sw.device
    i64 = torch.int64
    s_flat = as_u32(sw).reshape(-1)
    t_flat = tab.to(i64).reshape(-1)
    sel_flat = selectors.to(i64).reshape(-1)
    row = torch.arange(NB, device=dev, dtype=i64)
    s_base = row * SW
    t_base = row * tab.shape[1]
    sel_base = row * SEL_CAP
    lane = torch.arange(256, device=dev, dtype=i64)
    mtf = mtf_init.to(i64).clone()
    eob = n_used.to(i64) + 1
    ns = nsel.to(i64)
    zero = torch.zeros(NB, dtype=i64, device=dev)
    bitpos = sym_local.to(i64)
    gi, nrec, run_acc, run_bit, sym_h, err = (zero.clone() for _ in range(6))
    gpos = zero + GROUP
    held = torch.zeros(NB, dtype=torch.bool, device=dev)
    done = held.clone()
    # Column S takes the writes of blocks that emit nothing this trip.
    out = torch.zeros(NB * (S + 1), dtype=torch.int32, device=dev)
    o_base = row * (S + 1)

    trip = 0
    while trip % 16 or bool((~done & (nrec < S)).any()):
        trip += 1
        act = ~done & (nrec < S)
        t = torch.where(gi < SEL_CAP,
                        sel_flat[sel_base + torch.clamp(gi, max=SEL_CAP - 1)],
                        0).clamp(max=5)
        w = s_base + torch.clamp(bitpos >> 5, max=SW - 2)
        sh = bitpos & 31
        top = ((s_flat[w] << sh) & U32) | torch.where(
            sh > 0, s_flat[w + 1] >> ((32 - sh) & 31), 0)
        tb = t_base + t * TAB_STRIDE
        e1 = t_flat[tb + (top >> (32 - L1_BITS))]
        e2 = t_flat[tb + L1W + (e1 >> 5) + ((top >> (32 - L1_BITS - 5)) & 31)]
        e = torch.where((e1 & 31) == 31, e2, e1)
        ln = e & 31
        consume = act & ~held
        s = torch.where(held, sym_h, e >> 5)
        why = (torch.where(consume & (ln == 0), 1, 0)
               | torch.where(consume & (gi >= ns), 2, 0)
               | torch.where(act & (s > eob), 4, 0)
               | torch.where(act & (run_acc > (1 << 21)), 8, 0)
               | torch.where(act & (nrec >= S - 2), 16, 0))
        bad = why != 0

        is_run = s <= 1
        flush = act & ~is_run & (run_acc > 0)
        is_eob = act & ~is_run & (run_acc == 0) & (s == eob)
        is_plain = act & ~is_run & (run_acc == 0) & (s != eob) & ~bad

        # MTF^-1: the byte at rank j moves to the front.
        j = torch.clamp(s - 1, 0, 255)
        byte = mtf.gather(1, j[:, None])[:, 0]
        head = mtf[:, 0]
        moved = torch.where(lane == 0, byte[:, None], torch.roll(mtf, 1, 1))
        mtf = torch.where(is_plain[:, None] & (lane <= j[:, None]), moved, mtf)

        emit = flush | is_plain
        rec = torch.where(flush, (run_acc << 8) | head, (1 << 8) | byte)
        out[o_base + torch.where(emit, nrec, S)] = rec.to(torch.int32)

        grow = is_run & act & ~bad
        run_acc = torch.where(grow, run_acc + ((s + 1) << run_bit),
                              torch.where(flush, 0, run_acc))
        run_bit = torch.where(grow, run_bit + 1,
                              torch.where(flush, 0, run_bit))
        held = torch.where(act, flush & ~bad, held)
        sym_h = torch.where(flush, s, sym_h)
        step = consume & ~bad
        err = err | why | torch.where(bad & (err < 1024),
                                      (bitpos + 1) << 10, 0)
        bitpos = torch.where(step, bitpos + ln, bitpos)
        gpos = torch.where(step, gpos - 1, gpos)
        gi = torch.where(gpos == 0, gi + 1, gi)
        gpos = torch.where(gpos == 0, GROUP, gpos)
        done = done | is_eob | bad
        nrec = torch.where(emit, nrec + 1, nrec)
    meta = torch.stack([nrec.to(torch.int32), to_i32(err),
                        bitpos.to(torch.int32)], dim=1)
    return out.reshape(NB, S + 1)[:, :S], meta


def bzip2_records_plain(n_used, nsel, sym_local, sw, tab, selectors,
                        S: int):
    """The torch twin of the CUDA records pass: the walk of
    bzip2_walk_plain without the MTF list, one trip per symbol consumed
    (the symbol held after a run flush is handled on its flush's trip, as
    the kernel does). Arguments as bzip2_walk_plain but mtf_init; returns
    (recs [NB, S] int32: count << 8 | rank, the rank s - 1 of a literal or
    0 for a flushed run, meta as bzip2_walk_plain's)."""
    NB, SW = sw.shape
    dev = sw.device
    i64 = torch.int64
    s_flat = as_u32(sw).reshape(-1)
    t_flat = tab.to(i64).reshape(-1)
    sel_flat = selectors.to(i64).reshape(-1)
    row = torch.arange(NB, device=dev, dtype=i64)
    s_base = row * SW
    t_base = row * tab.shape[1]
    sel_base = row * SEL_CAP
    eob = n_used.to(i64) + 1
    ns = nsel.to(i64)
    zero = torch.zeros(NB, dtype=i64, device=dev)
    bitpos = sym_local.to(i64)
    gi, nrec, run_acc, run_bit, err = (zero.clone() for _ in range(5))
    gpos = zero + GROUP
    done = torch.zeros(NB, dtype=torch.bool, device=dev)
    # Column S takes the writes of blocks that emit nothing.
    out = torch.zeros(NB * (S + 1), dtype=torch.int32, device=dev)
    o_base = row * (S + 1)

    def emit(where, rec):
        out[o_base + torch.where(where, nrec, S)] = rec.to(torch.int32)
        return torch.where(where, nrec + 1, nrec)

    while not bool(done.all()):
        act = ~done
        t = torch.where(gi < SEL_CAP,
                        sel_flat[sel_base + torch.clamp(gi, max=SEL_CAP - 1)],
                        0).clamp(max=5)
        w = s_base + torch.clamp(bitpos >> 5, max=SW - 2)
        sh = bitpos & 31
        top = ((s_flat[w] << sh) & U32) | torch.where(
            sh > 0, s_flat[w + 1] >> ((32 - sh) & 31), 0)
        tb = t_base + t * TAB_STRIDE
        e1 = t_flat[tb + (top >> (32 - L1_BITS))]
        e2 = t_flat[tb + L1W + (e1 >> 5) + ((top >> (32 - L1_BITS - 5)) & 31)]
        e = torch.where((e1 & 31) == 31, e2, e1)
        ln = e & 31
        s = e >> 5
        why = (torch.where(ln == 0, 1, 0) | torch.where(gi >= ns, 2, 0)
               | torch.where(s > eob, 4, 0)
               | torch.where(run_acc > (1 << 21), 8, 0)
               | torch.where(nrec >= S - 2, 16, 0))
        bad = act & (why != 0)
        is_run = s <= 1
        flush = act & ~is_run & (run_acc > 0)
        nrec = emit(flush, run_acc << 8)
        err = torch.where(bad, why | ((bitpos + 1) << 10), err)
        step = act & ~bad
        bitpos = torch.where(step, bitpos + ln, bitpos)
        gpos = torch.where(step, gpos - 1, gpos)
        gi = torch.where(gpos == 0, gi + 1, gi)
        gpos = torch.where(gpos == 0, GROUP, gpos)
        grow = step & is_run
        run_acc = torch.where(grow, run_acc + ((s + 1) << run_bit),
                              torch.where(flush, 0, run_acc))
        run_bit = torch.where(grow, run_bit + 1,
                              torch.where(flush, 0, run_bit))
        # The held trip of a flush: the record cap, with the bit position
        # already advanced.
        capped = step & flush & (nrec >= S - 2)
        err = torch.where(capped, 16 | ((bitpos + 1) << 10), err)
        nonrun = step & ~is_run & ~capped
        nrec = emit(nonrun & (s != eob),
                    (1 << 8) | torch.clamp(s - 1, 0, 255))
        done = done | bad | capped | (nonrun & (s == eob))
    meta = torch.stack([nrec.to(torch.int32), to_i32(err),
                        bitpos.to(torch.int32)], dim=1)
    return out.reshape(NB, S + 1)[:, :S], meta


def mtf_decode_segments_plain(recs, meta, mtf_init, seg: int = REC_SEG):
    """The torch twin of the CUDA passes B1-B3 at segments of `seg`
    records: recs [NB, S] int32 count << 8 | rank (bzip2_records_plain),
    meta, mtf_init [NB, 256] uint8 -> recs count << 8 | byte, each block's
    records past meta[:, 0] as they were."""
    NB, S = recs.shape
    dev = recs.device
    nrec = meta[:, 0].to(torch.int64)
    top = int(nrec.max()) if NB else 0
    nseg = -(-top // seg)
    if nseg == 0:
        return recs.clone()
    n = nseg * seg
    pos = torch.arange(n, device=dev)
    live = pos[None, :] < nrec[:, None]
    r = torch.nn.functional.pad(recs[:, :min(n, S)].to(torch.int64),
                                (0, max(n - S, 0)))
    ranks = torch.where(live, r & 255, 0).reshape(NB * nseg, seg)
    # B1: each segment's ranks walked on the identity list of labels; a
    # record's label is the one at its rank, P_k the final list.
    lane = torch.arange(256, device=dev)
    lst = lane.expand(NB * nseg, 256).clone()
    labels = torch.zeros_like(ranks)
    for i in range(min(seg, top)):
        j = ranks[:, i:i + 1]
        lab = lst.gather(1, j)
        moved = torch.where(lane == 0, lab, torch.roll(lst, 1, 1))
        lst = torch.where(lane <= j, moved, lst)
        labels[:, i] = lab[:, 0]
    P = lst.reshape(NB, nseg, 256)
    # B2: L_0 = mtf_init, L_{k+1}[i] = L_k[P_k[i]].
    L = [mtf_init.to(torch.int64)]
    for k in range(nseg - 1):
        L.append(L[-1].gather(1, P[:, k]))
    L = torch.stack(L, dim=1)
    # B3: a label's byte in its segment's starting list.
    byte = L.gather(2, labels.reshape(NB, nseg, seg)).reshape(NB, n)
    out = torch.where(live, (r & ~255) | byte, r)[:, :S].to(torch.int32)
    return torch.cat([out, recs[:, out.shape[1]:]], dim=1)


def bzip2_walk(n_used, nsel, sym_local, sw, tab, selectors, mtf_init,
               S: int, mtf_seg: int = REC_SEG):
    """The symbol walk: the plain version for CPU tensors, the CUDA
    kernels (csrc/bzip2_walk.cu: the records pass, then the MTF^-1 in
    segments of `mtf_seg` records) for CUDA tensors. Arguments and
    results as bzip2_walk_plain; the per-block vectors, sw and tab int32,
    selectors and mtf_init uint8, all contiguous."""
    args = (n_used, nsel, sym_local, sw, tab, selectors, mtf_init)
    if sw.device.type == "cpu":
        return bzip2_walk_plain(*args, S)
    if sw.device.type != "cuda":
        raise ValueError(f"bzip2 walk: unsupported device {sw.device}")
    NB, SW = sw.shape
    specs = (("n_used", (NB,), torch.int32), ("nsel", (NB,), torch.int32),
             ("sym_local", (NB,), torch.int32),
             ("sw", (NB, SW), torch.int32),
             ("tab", (NB, 6 * TAB_STRIDE), torch.int32),
             ("selectors", (NB, SEL_CAP), torch.uint8),
             ("mtf_init", (NB, 256), torch.uint8))
    for t, (name, shape, dtype) in zip(args, specs):
        if (t.device != sw.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"bzip2 walk: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {sw.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if SW < 2 or S < 3 or mtf_seg < 1 or NB > 65535:
        raise ValueError(f"bzip2 walk: slices of {SW} words, {S} records "
                         f"per block, segments of {mtf_seg}, {NB} blocks; "
                         "need >= 2, >= 3, >= 1 and <= 65535")
    recs = torch.zeros((NB, S), dtype=torch.int32, device=sw.device)
    meta = torch.zeros((NB, META_WIDTH), dtype=torch.int32, device=sw.device)
    # Each segment's final label list P_k and starting list L_k.
    lists = torch.empty((2, NB, -(-S // mtf_seg), 256), dtype=torch.uint8,
                        device=sw.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(sw.device):
        for p, kernel in enumerate(bzip2_walk.kernels):
            rc = _build.lib().tpz_bzip2_walk(
                *(t.data_ptr() for t in args), recs.data_ptr(),
                meta.data_ptr(), lists[0].data_ptr(), lists[1].data_ptr(),
                NB, SW, S, mtf_seg, p, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"bzip2 walk: {kernel} launch failed: "
                                   f"cudaError {rc}")
    bzip2_walk.launches += 1
    return recs, meta


bzip2_walk.launches = 0
# The CUDA kernels of one call, in launch order (pass 0-3 of the C entry).
bzip2_walk.kernels = ("bzip2_records_kernel", "mtf_labels_kernel",
                      "mtf_lists_kernel", "mtf_bytes_kernel")


# ------------------------------------------------------- device stages


def expand_records(recs, meta, orig, N: int):
    """RLE2^-1 run expansion: records [NB, S], meta, orig [NB] int64 ->
    (last columns [NB, N] uint8, lengths [NB] int64, err [NB] int64: the
    walk's err with 32 where the records cover more than N bytes and 64
    where orig >= the length, orig [NB]). A row with err != 0 comes back
    empty with length 1 and orig 0, the reference's sanitized shape; a
    zero record pads every row to N bytes, so one repeat_interleave
    expands the whole batch."""
    NB, S = recs.shape
    live = torch.arange(S, device=recs.device)[None, :] < meta[:, :1]
    cnt = torch.where(live, recs.to(torch.int64) >> 8, 0)
    lens = cnt.sum(dim=1)
    err = (meta[:, 1].to(torch.int64) | torch.where(lens > N, 32, 0)
           | torch.where(lens <= orig, 64, 0))
    bad = err != 0
    cnt = torch.where(bad[:, None], 0, cnt)
    pad = N - torch.where(bad, 0, lens)
    reps = torch.cat([cnt, pad[:, None]], dim=1).reshape(-1)
    vals = torch.cat([(recs & 255).to(torch.uint8),
                      torch.zeros((NB, 1), dtype=torch.uint8,
                                  device=recs.device)], dim=1).reshape(-1)
    last = torch.repeat_interleave(vals, reps, output_size=NB * N)
    return (last.reshape(NB, N), torch.where(bad, 1, lens),
            err, torch.where(bad, 0, orig))


def block_layout(scan: dict, slices: np.ndarray) -> dict:
    """Host arrays of the walk's inputs for the scanned blocks whose
    symbol-bit slices are `slices` [NB, SCAP] uint8 (each starting at the
    byte of sym_bits // 8; SCAP a multiple of 4)."""
    return {"n_used": scan["n_useds"].astype(np.int32),
            "nsel": scan["nsels"].astype(np.int32),
            "sym_local": (scan["sym_bits"] & 7).astype(np.int32),
            "origs": scan["origs"].astype(np.int64),
            "sw": np.ascontiguousarray(slices).view(">u4").astype(np.int32),
            "tab": build_tables(scan["lens"], scan["n_useds"]),
            "selectors": np.ascontiguousarray(scan["selectors"], np.uint8),
            "mtf_init": np.ascontiguousarray(scan["mtf_init"], np.uint8)}


def decode_blocks_device(scan: dict, slices: np.ndarray, N: int,
                         device="cuda", rec_cap: int | None = None,
                         stage_hook=_nohook):
    """scan = oracle.bzip2_scan_headers dict; slices [NB, SCAP] uint8.
    Returns numpy (plain rows [NB, N] uint8, lens [NB], err [NB], end
    bitpos [NB]): walk, expand and inverse BWT on `device`, err being the
    walk's and the expansion's bits with 128 where the iBWT flags the
    block."""
    device = _device(device)
    with stage("bzip2", "slices", stage_hook):
        layout = block_layout(scan, slices)
    with stage("bzip2", "h2d", stage_hook):
        t = {k: torch.from_numpy(v).to(device) for k, v in layout.items()}
    with stage("bzip2", "walk", stage_hook):
        recs, meta = bzip2_walk(*(t[k] for k in WALK_ARGS),
                                records_cap(N, rec_cap))
    with stage("bzip2", "expand", stage_hook):
        last, lens, err, orig = expand_records(recs, meta, t["origs"], N)
        del recs
    plain, flag = ibwt_walk.ibwt_body(last, lens, orig,
                                      stage_hook=stage_hook)
    with stage("bzip2", "fetch", stage_hook):
        err = err | (flag.to(torch.int64) << 7)
        return tuple(x.cpu().numpy() for x in (plain, lens, err, meta[:, 2]))
