"""DEFLATE block planning on the device in torch (port of
tpz/kernels/deflate_plan_device.py): package-merge code lengths,
canonical codes, the RFC 1951 §3.2.7 code-length RLE, block types and
header-bit slots, as batched ops over [NB, ...] tensors. Bit-identical to
the reference (and through it to cpp/deflate.cc's planner).

Block-type choice is a sequential scan over the blocks (a stored block's
cost depends on the byte phase of its absolute bit position). It runs as
a host loop over numpy [NB] vectors after one small device-to-host copy:
a Python loop of torch ops over 512 blocks would launch thousands of tiny
kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch import constants as C

NLIT = C.DEFLATE_NUM_LITLEN          # 288
NDIST = 30
NCL = 19
MAX_BITS = C.DEFLATE_MAX_BITS        # 15
MAX_CL_BITS = C.DEFLATE_MAX_CL_BITS  # 7
JOINT = NLIT + 32                    # joint CL sequence capacity
STORED_CHUNK = 32768
_PAD = 1 << 29
NO_CHUNK1 = -(1 << 30)


def canonical_codes_np(lengths: np.ndarray) -> np.ndarray:
    """RFC 1951 §3.2.2 canonical code assignment (MSB-first code values)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = np.zeros(len(lengths), dtype=np.uint32)
    max_len = int(lengths.max(initial=0))
    if max_len == 0:
        return codes
    count = np.bincount(lengths, minlength=max_len + 1)
    count[0] = 0
    next_code = np.zeros(max_len + 1, dtype=np.int64)
    code = 0
    for ln in range(1, max_len + 1):
        code = (code + int(count[ln - 1])) << 1
        next_code[ln] = code
    for i, ln in enumerate(lengths):
        if ln:
            codes[i] = next_code[ln]
            next_code[ln] += 1
    return codes


def plan_tables() -> dict:
    """The planner's constant lookup tables, as numpy arrays."""
    fixed_ll = np.asarray(C.DEFLATE_FIXED_LITLEN_LENGTHS, np.int32)
    fixed_dl = np.asarray(C.DEFLATE_FIXED_DIST_LENGTHS, np.int32)
    return {
        "len_extra": np.asarray(C.DEFLATE_LENGTH_EXTRA, np.int32),
        "dist_extra": np.asarray(C.DEFLATE_DIST_EXTRA, np.int32),
        "cl_order": np.asarray(C.DEFLATE_CL_ORDER, np.int32),
        "fixed_ll": fixed_ll,
        "fixed_dl": fixed_dl,
        "fixed_lc": canonical_codes_np(fixed_ll).astype(np.int32),
        "fixed_dc": canonical_codes_np(fixed_dl).astype(np.int32),
    }


def _sort1(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1).values


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device, dtype=torch.int32)


def package_merge_lengths(freqs: torch.Tensor, limit: int,
                          pad: int = _PAD) -> torch.Tensor:
    """freqs [NB, NS] int32 (>= 0) -> code lengths [NB, NS] int32.

    Items are packed int32 keys (weight << 10 | is_package << 9 | sym);
    the row frequency sum must stay below 2^19 (DEFLATE blocks: <= 65537).
    Keys are distinct, so an unstable sort orders them like the
    reference's stable one."""
    NB, NS = freqs.shape
    sym = _iota(NS, freqs).expand(NB, NS)
    active = freqs > 0
    n = active.sum(dim=1, dtype=torch.int32)

    leaves = _sort1(torch.where(active, (freqs << 10) | sym, pad))
    pkcums = [torch.zeros((NB, 2 * NS), dtype=torch.int32,
                          device=freqs.device)]
    prev = torch.cat([leaves, torch.full_like(leaves, pad)], dim=1)
    for _ in range(1, limit):
        a, b = prev[:, 0::2], prev[:, 1::2]
        w = (a >> 10) + (b >> 10)
        msym = torch.minimum(a & 511, b & 511)
        pkg = torch.where(b < pad, (w << 10) | (1 << 9) | msym, pad)
        prev = _sort1(torch.cat([leaves, pkg], dim=1))
        is_pkg = ((prev >> 9) & 1) * (prev < pad)
        pkcums.append(torch.cumsum(is_pkg, dim=1, dtype=torch.int32))

    # Backward selection walk: t_limit = 2(n - 1).
    t = torch.clamp(2 * (n - 1), min=0)
    rank = _iota(NS, freqs).expand(NB, NS)
    len_by_rank = torch.zeros((NB, NS), dtype=torch.int32,
                              device=freqs.device)
    for lvl in range(limit, 0, -1):
        idx = torch.clamp(t - 1, 0, 2 * NS - 1).to(torch.int64)[:, None]
        pk = torch.where(t > 0, pkcums[lvl - 1].gather(1, idx)[:, 0], 0)
        len_by_rank = len_by_rank + (rank < (t - pk)[:, None]).to(torch.int32)
        t = 2 * pk
    # n == 1: the single active symbol gets length 1.
    len_by_rank = torch.where((n == 1)[:, None] & (rank == 0), 1, len_by_rank)

    # Rank-order lengths back to symbol order.
    live = leaves < pad
    out = torch.zeros((NB, NS), dtype=torch.int32, device=freqs.device)
    return out.scatter_reduce_(
        1, torch.where(live, leaves & 511, 0).to(torch.int64),
        torch.where(live, len_by_rank, 0), "amax")


def canonical_codes(lengths: torch.Tensor, max_bits: int) -> torch.Tensor:
    """lengths [NB, NS] int32 -> canonical codes [NB, NS] int32."""
    NB, NS = lengths.shape
    onehot = (lengths[:, :, None] == _iota(max_bits + 1, lengths)).to(
        torch.int32)                                           # [NB, NS, L+1]
    cnt = onehot.sum(dim=1, dtype=torch.int32)
    cnt[:, 0] = 0
    code = torch.zeros(NB, dtype=torch.int32, device=lengths.device)
    cols = [code]
    for ln in range(1, max_bits + 1):
        code = (code + cnt[:, ln - 1]) << 1
        cols.append(code)
    nc = torch.stack(cols, dim=1)                              # [NB, L+1]
    excl = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    rank = (excl * onehot).sum(dim=2, dtype=torch.int32)
    base = (nc[:, None, :] * onehot).sum(dim=2, dtype=torch.int32)
    return torch.where(lengths > 0, base + rank, 0)


def bit_reverse(code: torch.Tensor, nbits: torch.Tensor,
                max_bits: int) -> torch.Tensor:
    """Reverse the low `nbits` bits of code (LSB-first stream order)."""
    rev = torch.zeros_like(code)
    c = code
    for _ in range(max_bits):
        rev = (rev << 1) | (c & 1)
        c = c >> 1
    return torch.where(nbits > 0, rev >> (max_bits - nbits), 0)


def cl_tokens(joint: torch.Tensor, L: torch.Tensor):
    """Per-position CL RLE of the joint (litlen ++ dist) length sequence,
    emissions in position order (== cpp ClEncode). joint [NB, JOINT],
    L [NB]. Returns (emit bool, sym, extra_bits, extra_val) [NB, JOINT]."""
    NB, J = joint.shape
    i = _iota(J, joint).expand(NB, J)
    valid = i < L[:, None]
    v = torch.where(valid, joint, -1)
    prev = torch.cat([torch.full((NB, 1), -2, dtype=torch.int32,
                                 device=joint.device), v[:, :-1]], dim=1)
    run_start = valid & (v != prev)
    s = torch.cummax(torch.where(run_start, i, -1), dim=1).values
    big = 1 << 30
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(run_start, i, big), [1]), dim=1).values, [1])
    nxt = torch.nn.functional.pad(nxt[:, 1:], (0, 1), value=big)
    end = torch.minimum(nxt, L[:, None])
    t = i - s
    R = end - s

    # v != 0: t == 0 -> literal v; tail chunks of 6 after it.
    t2 = t - 1
    c6 = torch.div(t2, 6, rounding_mode="floor")
    rem6 = (R - 1) - 6 * c6
    start6 = torch.remainder(t2, 6) == 0
    nz_emit16 = (t > 0) & start6 & (rem6 >= 3)
    nz_lit_tail = (t > 0) & (rem6 < 3) & (rem6 >= 1)
    nz_emit = (t == 0) | nz_emit16 | nz_lit_tail

    # v == 0: chunks of 138.
    c138 = torch.div(t, 138, rounding_mode="floor")
    q = torch.clamp(R - 138 * c138, max=138)
    start138 = torch.remainder(t, 138) == 0
    z18 = start138 & (q >= 11)
    z17 = start138 & (q >= 3) & (q < 11)
    z_emit = z18 | z17 | (q < 3)

    is_zero = v == 0
    emit = valid & torch.where(is_zero, z_emit, nz_emit)
    sym = torch.where(is_zero, torch.where(z18, 18, torch.where(z17, 17, 0)),
                      torch.where(nz_emit16, 16, v))
    extra_bits = torch.where(
        is_zero, torch.where(z18, 7, torch.where(z17, 3, 0)),
        torch.where(nz_emit16, 2, 0))
    extra_val = torch.where(
        is_zero, torch.where(z18, q - 11, torch.where(z17, q - 3, 0)),
        torch.where(nz_emit16, torch.clamp(rem6, max=6) - 3, 0))
    return (emit, torch.where(emit, sym, 0), torch.where(emit, extra_bits, 0),
            torch.where(emit, extra_val, 0))


def _last_used(lengths: torch.Tensor, lo: int, floor: int) -> torch.Tensor:
    """max(floor, 1 + the highest index >= lo with a nonzero length)."""
    idx = _iota(lengths.shape[1], lengths)
    hit = (lengths > 0) & (idx >= lo)
    return torch.clamp(torch.where(hit, idx + 1, 0).amax(dim=1), min=floor)


def plan_from_freqs(lit_hist: torch.Tensor, dist_hist: torch.Tensor,
                    tables: dict) -> dict:
    """Twin of cpp PlanFromFreqs. lit_hist [NB, 288] (EOB forced to 1
    here), dist_hist [NB, 30]; `tables` = plan_tables() as tensors."""
    NB = lit_hist.shape[0]
    lit_freq = lit_hist.to(torch.int32).clone()
    lit_freq[:, 256] = 1
    dist_freq = dist_hist.to(torch.int32)
    extra_total = ((lit_freq[:, 257:286] * tables["len_extra"]).sum(1)
                   + (dist_freq * tables["dist_extra"]).sum(1))

    lit_len = package_merge_lengths(lit_freq, MAX_BITS)
    dist_len = package_merge_lengths(dist_freq, MAX_BITS)
    lit_code = canonical_codes(lit_len, MAX_BITS)
    dist_code = canonical_codes(dist_len, MAX_BITS)
    nlit = _last_used(lit_len, 257, 257)
    ndist = _last_used(dist_len, 1, 1)

    # joint = lit_len[0:nlit] ++ dist_len[0:ndist]
    j = _iota(JOINT, lit_len)[None, :]
    di = torch.clamp(j - nlit[:, None], 0, NDIST - 1).to(torch.int64)
    lit_pad = torch.nn.functional.pad(lit_len, (0, JOINT - NLIT))
    joint = torch.where(j < nlit[:, None], lit_pad,
                        torch.gather(dist_len, 1, di))
    emit, cl_sym, cl_eb, cl_ev = cl_tokens(joint, nlit + ndist)

    cl_onehot = ((cl_sym[:, :, None] == _iota(NCL, cl_sym))
                 & emit[:, :, None]).to(torch.int32)
    cl_freq = cl_onehot.sum(dim=1, dtype=torch.int32)
    cl_len = package_merge_lengths(cl_freq, MAX_CL_BITS)
    cl_code = canonical_codes(cl_len, MAX_CL_BITS)
    cl_len_ord = cl_len[:, tables["cl_order"].to(torch.int64)]
    ncl = _last_used(cl_len_ord, 4, 4)

    # dyn header bits: 14 + 3*ncl + sum(cl_len[sym] + extra_bits)
    cl_len_at = (cl_onehot * cl_len[:, None, :]).sum(dim=2, dtype=torch.int32)
    dyn_header = 14 + 3 * ncl + torch.where(emit, cl_len_at + cl_eb, 0).sum(1)
    dyn_body = ((lit_freq * lit_len).sum(1) + (dist_freq * dist_len).sum(1)
                + extra_total)
    fixed_body = ((lit_freq * tables["fixed_ll"]).sum(1)
                  + (dist_freq * tables["fixed_dl"]).sum(1) + extra_total)
    i32 = torch.int32
    return {
        "lit_len": lit_len, "lit_code": lit_code,
        "dist_len": dist_len, "dist_code": dist_code,
        "nlit": nlit.to(i32), "ndist": ndist.to(i32), "ncl": ncl.to(i32),
        "cl_len": cl_len, "cl_code": cl_code, "cl_len_ord": cl_len_ord,
        "cl_emit": emit, "cl_sym": cl_sym, "cl_eb": cl_eb, "cl_ev": cl_ev,
        "cl_len_at": cl_len_at,
        "dyn_header_bits": dyn_header.to(i32),
        "dyn_body_bits": dyn_body.to(i32),
        "fixed_body_bits": fixed_body.to(i32),
    }


def _stored_cost_parts(start: int, blen: int):
    """cpp StoredCost for block_len <= 65536 (at most 2 chunks)."""
    c0 = min(blen, STORED_CHUNK)
    c1 = blen - c0
    pad0 = (8 - ((start + 3) & 7)) & 7
    cost0 = 3 + pad0 + 32 + 8 * c0
    # After chunk 0 the position is byte-aligned -> pad is always 5.
    cost1 = 3 + 5 + 32 + 8 * c1 if c1 > 0 else 0
    return cost0 + cost1, pad0, c0, c1


def choose_btypes(dyn_cost_wo3, fixed_body, block_len, buf_start,
                  dyn_header, live=None) -> dict:
    """Sequential scan over blocks: block types, absolute offsets, block
    starts. Inputs are [NB] numpy vectors; buf_start marks blocks that
    begin a new (word-aligned) output buffer; live False marks padding
    blocks that emit nothing. Returns numpy int32 vectors btype, start,
    body_off, chunk1_off (NO_CHUNK1 when absent), end_pos."""
    NB = len(block_len)
    if live is None:
        live = np.ones(NB, bool)
    out = {k: np.zeros(NB, np.int32)
           for k in ("btype", "start", "body_off", "chunk1_off", "end_pos")}
    pos = 0
    for b in range(NB):
        blen = int(block_len[b])
        if buf_start[b]:
            pos = (pos + 31) & ~31
        start = pos
        dyn_cost = 3 + int(dyn_cost_wo3[b])
        fixed_cost = 3 + int(fixed_body[b])
        stored_cost, pad0, c0, c1 = _stored_cost_parts(start, blen)
        use_stored = (blen > 0 and stored_cost < dyn_cost
                      and stored_cost < fixed_cost)
        use_fixed = not use_stored and fixed_cost <= dyn_cost
        if use_stored:
            btype, cost = 0, stored_cost
            body_off = start + 3 + pad0 + 32
        elif use_fixed:
            btype, cost, body_off = 1, fixed_cost, start + 3
        else:
            btype, cost = 2, dyn_cost
            body_off = start + 3 + int(dyn_header[b])
        chunk1 = (start + 3 + pad0 + 32 + 8 * c0 + 3 + 5 + 32
                  if use_stored and c1 > 0 else NO_CHUNK1)
        if not live[b]:
            btype, cost = 0, 0   # padding blocks emit nothing
        pos = start + cost
        out["btype"][b] = btype
        out["start"][b] = start
        out["body_off"][b] = body_off
        out["chunk1_off"][b] = chunk1
        out["end_pos"][b] = pos
    return out


def header_slots(plan: dict, sched: dict, block_len: torch.Tensor,
                 bfinal: torch.Tensor, live: torch.Tensor):
    """Header-bit slots [NB, H] (vals int64 u32, nbits int32, offs int32)
    replicating EmitBlockHeader / EmitStored at absolute bit offsets.
    H = 4 + 1 + 19 + JOINT. Padding blocks (live False) emit zero bits."""
    NB = block_len.shape[0]
    dev = block_len.device
    btype = sched["btype"]
    start = sched["start"]
    stored = btype == 0
    dyn = btype == 2
    c0 = torch.clamp(block_len, max=STORED_CHUNK)
    c1 = block_len - c0
    pad0 = (8 - ((start + 3) & 7)) & 7
    i64 = torch.int64

    # BFINAL|BTYPE (3 bits); a stored block's first chunk carries BFINAL
    # only when it is the only chunk.
    b0 = torch.where(stored, bfinal & (c1 == 0), bfinal).to(i64)
    s0 = (b0 | (btype.to(i64) << 1), torch.full_like(block_len, 3), start)
    # Stored: chunk-0 LEN|NLEN at start+3+pad0; chunk 1 at chunk 0's end:
    # 3 header bits, 5 pad bits, LEN|NLEN.
    sA = (c0.to(i64) | ((~c0 & 0xFFFF).to(i64) << 16),
          torch.where(stored, 32, 0), start + 3 + pad0)
    c1_start = start + 3 + pad0 + 32 + 8 * c0
    sB = (torch.where(c1 > 0, bfinal.to(i64), 0),
          torch.where(stored & (c1 > 0), 3, 0), c1_start)
    sC = (c1.to(i64) | ((~c1 & 0xFFFF).to(i64) << 16),
          torch.where(stored & (c1 > 0), 32, 0), c1_start + 8)

    # Dynamic: HLIT|HDIST|HCLEN (14 bits), 3-bit CL lengths in kClOrder,
    # then the CL tokens; sequential from start + 3.
    hd_val = ((plan["nlit"] - 257) | ((plan["ndist"] - 1) << 5)
              | ((plan["ncl"] - 4) << 10)).to(i64)
    hd_n = torch.where(dyn, 14, 0)
    oi = torch.arange(NCL, device=dev)[None, :]
    cln = torch.where(dyn[:, None] & (oi < plan["ncl"][:, None]), 3, 0)
    cl_code_at = (((plan["cl_sym"][:, :, None]
                    == torch.arange(NCL, device=dev))
                   & plan["cl_emit"][:, :, None]).to(torch.int32)
                  * plan["cl_code"][:, None, :]).sum(dim=2, dtype=torch.int32)
    rev = bit_reverse(cl_code_at, plan["cl_len_at"], MAX_CL_BITS)
    tok_val = (rev | (plan["cl_ev"] << plan["cl_len_at"])).to(i64)
    tok_n = torch.where(dyn[:, None] & plan["cl_emit"],
                        plan["cl_len_at"] + plan["cl_eb"], 0)
    dyn_n = torch.cat([hd_n[:, None], cln, tok_n], dim=1).to(torch.int32)
    dyn_off = (start[:, None] + 3 + torch.cumsum(dyn_n, dim=1) - dyn_n)
    dyn_val = torch.cat([hd_val[:, None], plan["cl_len_ord"].to(i64),
                         tok_val], dim=1)

    vals = torch.cat([torch.stack([s[0] for s in (s0, sA, sB, sC)], 1),
                      dyn_val], dim=1)
    nbits = torch.cat([torch.stack([s[1] for s in (s0, sA, sB, sC)], 1)
                       .to(torch.int32), dyn_n], dim=1)
    offs = torch.cat([torch.stack([s[2] for s in (s0, sA, sB, sC)], 1),
                      dyn_off], dim=1).to(torch.int32)
    nbits = torch.where(live[:, None], nbits, 0)
    return vals, nbits, offs


def body_tables(plan: dict, btype: torch.Tensor, tables: dict):
    """Per-block stage-2 tables: packed (bit-reversed code) | (len << 16)
    for litlen [NB, 288] and dist [NB, 30]; EOB code/len [NB]. Fixed
    blocks use the RFC fixed code; stored blocks zero."""
    dynb = (btype == 2)[:, None]
    fixb = (btype == 1)[:, None]

    def pick(dyn_t, fixed_t):
        return torch.where(dynb, dyn_t, torch.where(fixb, fixed_t[None, :], 0))

    ll = pick(plan["lit_len"], tables["fixed_ll"])
    lc = pick(plan["lit_code"], tables["fixed_lc"])
    dl = pick(plan["dist_len"], tables["fixed_dl"])
    dc = pick(plan["dist_code"], tables["fixed_dc"])
    lrev = bit_reverse(lc, ll, MAX_BITS)
    drev = bit_reverse(dc, dl, MAX_BITS)
    return (lrev | (ll << 16), drev | (dl << 16), lrev[:, 256].to(torch.int64),
            ll[:, 256])


def plan_device(lit_hist, dist_hist, block_len, buf_start, bfinal,
                tables: dict, live=None) -> dict:
    """Histograms -> everything the bit packer needs. All tensors on one
    device; `tables` = plan_tables() as int32 tensors on that device;
    live [NB] bool (False: padding block). Returns btype, body_off,
    chunk1_off, end_pos, lit_cl, dist_cl, eob_val, eob_n, hdr_vals,
    hdr_nbits, hdr_offs."""
    dev = lit_hist.device
    block_len = block_len.to(torch.int32)
    if live is None:
        live = torch.ones_like(block_len, dtype=torch.bool)
    plan = plan_from_freqs(lit_hist, dist_hist, tables)
    costs = torch.stack([plan["dyn_header_bits"] + plan["dyn_body_bits"],
                         plan["fixed_body_bits"], plan["dyn_header_bits"],
                         block_len, buf_start.to(torch.int32),
                         live.to(torch.int32)]).cpu().numpy()
    sched_np = choose_btypes(costs[0], costs[1], costs[3], costs[4] != 0,
                             costs[2], costs[5] != 0)
    sched = {k: torch.from_numpy(v).to(dev) for k, v in sched_np.items()}
    hv, hn, ho = header_slots(plan, sched, block_len, bfinal.to(torch.bool),
                              live)
    lit_cl, dist_cl, eob_val, eob_n = body_tables(plan, sched["btype"],
                                                  tables)
    return {
        "btype": sched["btype"], "body_off": sched["body_off"],
        "chunk1_off": sched["chunk1_off"], "end_pos": sched["end_pos"],
        "lit_cl": lit_cl, "dist_cl": dist_cl,
        "eob_val": eob_val, "eob_n": eob_n,
        "hdr_vals": hv, "hdr_nbits": hn, "hdr_offs": ho,
    }
