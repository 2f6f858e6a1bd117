"""Inverse BWT as list ranking by splitters on one torch device (port of
tpz/kernels/ibwt_walk.py).

tvec, the LF-mapping permutation, is one cycle over a block's n live
nodes; walking it from tvec[orig] emits the plaintext in forward order.
Every node j with (j & (SEG-1)) == 0, and the start node tvec[orig], is a
splitter: the segments between consecutive splitters partition the cycle.
  sort     tvec from one torch.sort of the unique int64 keys
           (last << 21) | idx, packed as w = tvec << 8 | last
  walk     chain c walks from its splitter (node c * SEG, or the start
           node) to the next one: its length and successor chain, and (on
           a card) its bytes, staged in chunks
  stitch   each block ranks its chains along the successors from the
           start chain, giving every chain its output offset; a block
           whose successors do not visit every live chain once and cover
           n bytes is flagged (a periodic block: its LF map has several
           cycles)
  place    every chain's bytes go to its offset (the plain version walks
           each chain again; the kernels copy the staged chunks)
The three steps after the sort are the CUDA kernels of csrc/ibwt_walk.cu
on a card (walk, a parallel stitch by pointer jumping, place), and
ibwt_rank_plain is their torch twin. The TPU design's slot streams, their
cap (CAP) and the placement sort do not carry over: chain offsets come
from the stitch, so no block is declined for capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.utils.profiling import _nohook, stage

MAX_N = 1 << 21           # keys hold the index in 21 bits
# Splitter stride, below the reference's _seg_for(N) (2048 at N = 2^20): a
# walk lasts as long as its longest chain, about ln(chains) x SEG steps,
# so a shorter stride shortens that tail and puts more loads in flight;
# the stitch (log-depth; in shared memory up to ~28 k live chains a
# block, a 900 k block at 32, in global memory past that) and the
# placement's copy grow with the chains. At the bzip2 decode headline 32
# is the fastest of 16-2048 (ibwt_stride.py; PERF.md).
IBWT_SEG = 32
# Walk threads resident per SM (0: as many as fit, 2,048 on the H100).
# Threads resident together walk nearby chains, so they read a few rows of
# w at a time: fewer of them keep those rows' sectors in L2, more put more
# loads in flight. At SEG 32 on the H100, 1,024 (about 4 of the 36
# headline rows at a time) and 768 measured fastest of 512-2,048, within
# 2.5% of each other in two runs (1,024: 0.828 and 0.833 ms, against
# 1.035 and 1.014 uncapped; ibwt_stride.py, PERF.md).
IBWT_WALK_RESIDENT = 1024


def stage_cap(seg: int) -> int:
    """Bytes of a staging chunk at stride seg: twice the mean chain, so
    that about e^-2 of the chains link a second chunk; a multiple of 4
    (the walk stores four bytes at a time)."""
    return max(16, 2 * seg)


def pool_chunks(N: int, cap: int) -> int:
    """A block's pool of linked chunks: a chain of len bytes takes
    ceil(len / cap) - 1 of them, so chains that cover at most N bytes
    never run it dry."""
    return N // cap + 1


def chains_per_block(N: int, seg: int) -> int:
    """Chains a block of N nodes may hold: one per SEG nodes, and the
    start chain."""
    return -(-N // seg) + 1


def _check_seg(N: int, seg: int) -> int:
    if seg < 1 or seg & (seg - 1):
        raise ValueError(f"ibwt: seg {seg} must be a power of two")
    return int(np.log2(seg))


def _chain_starts(start_g, length, seg: int, KC: int):
    """Per chain [NB, KC]: (its first node, whether it is live), and per
    block (the start chain's id, the number of live chains)."""
    m = int(np.log2(seg))
    K = (length + seg - 1) >> m
    sg_reg = (start_g & (seg - 1)) == 0
    start_id = torch.where(sg_reg, start_g >> m, K)
    n_live = K + torch.where(sg_reg, 0, 1)
    c = torch.arange(KC, device=start_g.device, dtype=start_g.dtype)[None, :]
    live = (c < n_live[:, None]) & (length[:, None] >= 1)
    first = torch.where(c == K[:, None], start_g[:, None], c << m)
    return torch.where(live, first, 0), live, start_id, n_live


def ibwt_walk_plain(w, start_g, length, seg: int):
    """The plain version of the iBWT walk: chains vectorised, one loop
    trip per step of the longest segment, then the stitch (one trip per
    live chain) and the placement walk.

    w [NB, N] int32 (tvec << 8 | byte at live nodes); start_g, length [NB]
    int32. Returns (out [NB, N] uint8: the plaintext in [0, length), zero
    elsewhere and in flagged rows; flag [NB] int32: 1 where the walk does
    not cover the block in one cycle, or length < 1)."""
    NB, N = w.shape
    _check_seg(N, seg)
    dev = w.device
    KC = chains_per_block(N, seg)
    i64 = torch.int64
    wf = w.to(i64).reshape(-1)
    st = start_g.to(i64)
    n = length.to(i64)
    first, live, start_id, n_live = _chain_starts(st, n, seg, KC)
    base = torch.arange(NB, device=dev, dtype=i64)[:, None] * N

    # Pass 1: lengths and successors.
    cur = first.clone()
    cnt = torch.zeros((NB, KC), dtype=i64, device=dev)
    succ = torch.full((NB, KC), -1, dtype=i64, device=dev)
    act = live.clone()
    trip = 0
    while trip % 16 or bool(act.any()):
        trip += 1
        nxt = wf[base + cur.clamp(0, N - 1)] >> 8
        cnt = cnt + act.to(i64)
        stop = act & (((nxt & (seg - 1)) == 0) | (nxt == st[:, None]))
        succ = torch.where(stop, torch.where(nxt == st[:, None],
                                             start_id[:, None],
                                             nxt >> int(np.log2(seg))), succ)
        # A chain longer than the block cannot be one cycle's segment.
        act = act & ~stop & (cnt <= n[:, None])
        cur = torch.where(act, nxt, cur)

    # Stitch: offsets along the successor walk from the start chain, which
    # must visit every live chain once and come back to the start.
    # Column KC of goff takes the writes of blocks that are done.
    goff = torch.full((NB, KC + 1), -1, dtype=i64, device=dev)
    cnt = torch.cat([cnt, torch.zeros((NB, 1), dtype=i64, device=dev)], 1)
    succ = torch.cat([succ, torch.zeros((NB, 1), dtype=i64, device=dev)], 1)
    rows = torch.arange(NB, device=dev)
    at = start_id.clone()
    acc = torch.zeros(NB, dtype=i64, device=dev)
    ok = n >= 1
    for i in range(KC):
        on = ok & (i < n_live)
        cid = torch.where(on & (at >= 0) & (at < KC), at, KC)
        ok = ok & ~(on & ((cid == KC) | (goff[rows, cid] >= 0)))
        cid = torch.where(on & ok, cid, KC)
        goff[rows, cid] = torch.where(cid < KC, acc, -1)
        acc = acc + cnt[rows, cid]
        at = torch.where(cid < KC, succ[rows, cid], at)
    ok = ok & (at == start_id) & (acc == n)
    goff = torch.where(ok[:, None], goff[:, :KC], -1)
    cnt = cnt[:, :KC]

    # Pass 2: each chain writes its bytes at goff + i.
    out = torch.zeros(NB * N + 1, dtype=torch.uint8, device=dev)
    cur = first.clone()
    act = goff >= 0
    i = torch.zeros((NB, KC), dtype=i64, device=dev)
    while bool(act.any()):
        v = wf[base + cur.clamp(0, N - 1)]
        out[torch.where(act, base + goff + i, NB * N)] = (v & 255).to(
            torch.uint8)
        i = i + 1
        act = act & (i < cnt)
        cur = torch.where(act, v >> 8, cur)
    return out[:NB * N].reshape(NB, N), (~ok).to(torch.int32)


def ibwt_rank_plain(w, start_g, length, seg: int, cap: int | None = None):
    """The kernels' torch twin (csrc/ibwt_walk.cu), vectorised over
    chains: the walk stages each chain's bytes in chunks of `cap` bytes
    (stage_cap(seg) by default; its own chunk, then chunks taken in turn
    from its block's pool of pool_chunks(N, cap) and linked); the stitch
    checks that the live chains' successors are a permutation of them,
    jumps pointers (cut at the start chain) until every live chain
    reaches the start chain, and requires the start chain's total n (a
    single cycle); the placement copies each chain's chunks to its
    offset. Arguments as ibwt_walk_plain, whose (out, flag) it returns,
    with [pool chunks taken, blocks whose pool ran dry]."""
    NB, N = w.shape
    m = _check_seg(N, seg)
    cap = stage_cap(seg) if cap is None else cap
    PC = pool_chunks(N, cap)
    dev = w.device
    KC = chains_per_block(N, seg)
    i64 = torch.int64
    wf = w.to(i64).reshape(-1)
    st = start_g.to(i64)
    n = length.to(i64)
    first, live, start_id, n_live = _chain_starts(st, n, seg, KC)
    base = torch.arange(NB, device=dev, dtype=i64)[:, None] * N
    blk = torch.arange(NB, device=dev, dtype=i64)[:, None]

    # The walk: lengths, successors and staged bytes. Chunk NB * KC + NB *
    # PC takes the bytes of chains that no longer stage.
    dump = NB * KC + NB * PC
    stage = torch.zeros((dump + 1) * cap, dtype=torch.uint8, device=dev)
    link = torch.full((dump,), -1, dtype=i64, device=dev)
    chunk = torch.arange(NB * KC, device=dev, dtype=i64).reshape(NB, KC)
    r = torch.zeros((NB, KC), dtype=i64, device=dev)
    pool_top = torch.zeros(NB, dtype=i64, device=dev)
    spill = torch.zeros(NB, dtype=torch.bool, device=dev)
    staging = live.clone()
    cur = first.clone()
    cnt = torch.zeros((NB, KC), dtype=i64, device=dev)
    succ = torch.full((NB, KC), -1, dtype=i64, device=dev)
    act = live.clone()
    while bool(act.any()):
        v = wf[base + cur.clamp(0, N - 1)]
        put = act & staging
        stage[torch.where(put, chunk * cap + r, dump * cap)] = (
            v & 255).to(torch.uint8)
        r = r + put.to(i64)
        nxt = v >> 8
        cnt = cnt + act.to(i64)
        stop = act & (((nxt & (seg - 1)) == 0) | (nxt == st[:, None]))
        succ = torch.where(stop, torch.where(nxt == st[:, None],
                                             start_id[:, None], nxt >> m),
                           succ)
        act = act & ~stop & (cnt <= n[:, None])
        cur = torch.where(act, nxt, cur)
        need = act & staging & (r == cap)
        if bool(need.any()):
            j = pool_top[:, None] + need.to(i64).cumsum(1) - 1
            got = need & (j < PC)
            spill = spill | (need & ~got).any(1)
            staging = staging & ~(need & ~got)
            new = NB * KC + blk * PC + j
            link[chunk[got]] = new[got]
            chunk = torch.where(got, new, chunk)
            r = torch.where(got, 0, r)
            pool_top = pool_top + need.to(i64).sum(1)
    ln = torch.where(live, cnt, 0)

    # The stitch: the successors of the live chains must be live chains,
    # none reached twice; then pointer jumping to the start chain.
    nl = n_live
    bad = (n < 1) | (nl > KC) | (start_id < 0) | (start_id >= nl) | spill
    okn = (succ >= 0) & (succ < nl[:, None])
    bad = bad | (live & ~okn).any(1)
    hits = torch.zeros((NB, KC + 1), dtype=i64, device=dev)
    hits.scatter_add_(1, torch.where(live & okn, succ, KC), live.to(i64))
    bad = bad | (hits[:, :KC] > 1).any(1)
    term = -2
    P = torch.where(live, torch.where(succ == start_id[:, None], term,
                                      succ.clamp(0, KC - 1)), term)
    S = ln.clone()
    # As many rounds as the kernel's: a path of nl chains needs
    # ceil(log2 nl); the kernel may stop early, once nothing moves.
    for _ in range(int(nl.max()).bit_length() + 1):
        go = P != term
        if not bool(go.any()):
            break
        pc = P.clamp(0, KC - 1)
        S = torch.where(go, torch.clamp(S + S.gather(1, pc), max=1 << 30),
                        S)
        P = torch.where(go, P.gather(1, pc), term)
    # The start chain's cycle covers n nodes only if it holds every live
    # chain (a permutation; each chain at least one node, none shared).
    s_start = S.gather(1, start_id.clamp(0, KC - 1)[:, None])[:, 0]
    ok = ~bad & (s_start == n)
    goff = torch.where(ok[:, None] & live, n[:, None] - S, -1)

    # The placement: each chain's chunks, in link order, at its offset.
    out = torch.zeros(NB * N + 1, dtype=torch.uint8, device=dev)
    at = torch.arange(cap, device=dev, dtype=i64)
    q = 0
    chunk = torch.arange(NB * KC, device=dev, dtype=i64).reshape(NB, KC)
    on = goff >= 0
    while bool(on.any()):
        take = torch.clamp(ln - q * cap, 0, cap)
        on = on & (take > 0)
        ci = torch.where(on, chunk, dump)
        src = stage.reshape(-1, cap)[ci]                      # [NB, KC, cap]
        dst = base[:, :, None] + goff[:, :, None] + q * cap + at
        mask = on[:, :, None] & (at < take[:, :, None])
        out[torch.where(mask, dst, NB * N)] = torch.where(mask, src, 0)
        chunk = torch.where(on, link[chunk.clamp(0, dump - 1)], chunk)
        q += 1
    flag = (~ok).to(torch.int32)
    return (out[:NB * N].reshape(NB, N), flag,
            [int(pool_top.sum()), int(spill.sum())])


def ibwt(w, start_g, length, seg: int, resident: int | None = None):
    """The iBWT walk: the plain version for CPU tensors, the CUDA kernels
    (csrc/ibwt_walk.cu: walk with staged bytes, stitch by pointer jumping,
    place) for CUDA tensors. Arguments and results as ibwt_walk_plain;
    all int32 and contiguous, as lf_inputs makes them. resident caps the
    walk threads resident per SM on a card (IBWT_WALK_RESIDENT when None,
    0 for no cap); the result does not depend on it."""
    if w.device.type == "cpu":
        return ibwt_walk_plain(w, start_g, length, seg)
    if w.device.type != "cuda":
        raise ValueError(f"ibwt: unsupported device {w.device}")
    NB, N = w.shape
    m = _check_seg(N, seg)
    for name, t, shape in (("w", w, (NB, N)), ("start_g", start_g, (NB,)),
                           ("length", length, (NB,))):
        if (t.device != w.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"ibwt: {name} must be a contiguous int32 tensor of shape "
                f"{shape} on {w.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    KC = chains_per_block(N, seg)
    cap = stage_cap(seg)
    PC = pool_chunks(N, cap)
    chunks = NB * (KC + PC)
    if chunks >= 1 << 31:
        raise ValueError(f"ibwt: {chunks} staging chunks exceed int32 links")
    out = torch.zeros((NB, N), dtype=torch.uint8, device=w.device)
    flag = torch.empty(NB, dtype=torch.int32, device=w.device)
    # Lengths, successors, offsets; links; the stitch's bitmap; pool tops
    # and spill flags.
    scratch = torch.empty(3 * NB * KC + chunks + NB * (-(-KC // 32)) + 2 * NB,
                          dtype=torch.int32, device=w.device)
    stage = torch.empty(chunks * cap, dtype=torch.uint8, device=w.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(w.device):
        rc = _build.lib().tpz_ibwt_walk(
            w.data_ptr(), start_g.data_ptr(), length.data_ptr(),
            scratch.data_ptr(), stage.data_ptr(), out.data_ptr(),
            flag.data_ptr(), NB, N, m, KC, cap, PC,
            IBWT_WALK_RESIDENT if resident is None else resident,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ibwt kernel launch failed: cudaError {rc}")
    ibwt.launches += 1
    return out, flag


ibwt.launches = 0
ibwt.kernels = ("ibwt_rank_walk", "ibwt_rank_stitch", "ibwt_rank_place")


def walk_resident(resident: int | None = None) -> int:
    """Walk threads resident per SM on the current card when `resident`
    are asked for (IBWT_WALK_RESIDENT when None, 0 for no cap)."""
    from tpz_torch.kernels import _build

    return _build.lib().tpz_ibwt_walk_resident(
        IBWT_WALK_RESIDENT if resident is None else resident)


def lf_inputs(last, length, orig):
    """The walk's inputs from last [NB, N] (any integer type, 0-padded),
    length and orig [NB]: (w [NB, N], start_g [NB], length [NB], all
    int32; valid [NB] bool). A row whose length and orig pointer are out
    of range (length < 1, above N, orig not below length) is not valid
    and goes to the walk with length 0, which flags it."""
    NB, N = last.shape
    if N > MAX_N:
        raise ValueError(f"ibwt: blocks of {N} nodes, at most {MAX_N}")
    dev = last.device
    length = length.to(dev, torch.int64)
    orig = orig.to(dev, torch.int64)
    valid = (length >= 1) & (length <= N) & (orig >= 0) & (orig < length)
    length = torch.where(valid, length, 0)
    idx = torch.arange(N, device=dev, dtype=torch.int64)
    live = idx[None, :] < length[:, None]
    li = last.to(torch.int64)
    key = torch.where(live, (li << 21) | idx, torch.iinfo(torch.int64).max)
    tvec = torch.sort(key, dim=1).values & (MAX_N - 1)
    del key
    start_g = tvec.gather(1, orig.clamp(0, N - 1)[:, None])[:, 0]
    w = torch.where(live, (tvec << 8) | li, 0).to(torch.int32)
    return (w, start_g.to(torch.int32), length.to(torch.int32), valid)


def ibwt_body(last, length, orig, seg: int = IBWT_SEG,
              stage_hook=_nohook):
    """last [NB, N] (any integer type, 0-padded), length, orig [NB] ->
    (out [NB, N] uint8 plaintext rows, flag [NB] int32). A row is flagged
    where its LF map is not one cycle (a periodic block) or its length
    and orig pointer are out of range."""
    with stage("bzip2", "sort", stage_hook):
        w, start_g, length, valid = lf_inputs(last, length, orig)
    with stage("bzip2", "ibwt", stage_hook):
        out, flag = ibwt(w, start_g, length, seg)
    return out, flag | (~valid).to(torch.int32)


def ibwt_blocks_fast(last: np.ndarray, lengths: np.ndarray,
                     origs: np.ndarray, device="cuda",
                     seg: int = IBWT_SEG) -> np.ndarray | None:
    """[NB, N] last columns -> plaintext rows, N bucketed to a power of two
    of at least 256. Returns None when a block is flagged (periodic, or
    out-of-range length or orig): the caller uses the host decoder."""
    device = _device(device)
    NB, N0 = last.shape
    N = max(256, 1 << (N0 - 1).bit_length())
    lastp = np.zeros((NB, N), np.uint8)
    lastp[:, :N0] = last
    out, flag = ibwt_body(torch.from_numpy(lastp).to(device),
                          torch.from_numpy(np.asarray(lengths, np.int64)),
                          torch.from_numpy(np.asarray(origs, np.int64)),
                          seg=seg)
    if int(flag.sum()) != 0:
        return None
    return out[:, :N0].cpu().numpy()
