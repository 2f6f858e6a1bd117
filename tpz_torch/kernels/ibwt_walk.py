"""Inverse BWT as list ranking by splitters on one torch device (port of
tpz/kernels/ibwt_walk.py).

tvec, the LF-mapping permutation, is one cycle over a block's n live
nodes; walking it from tvec[orig] emits the plaintext in forward order.
Every node j with (j & (SEG-1)) == 0, and the start node tvec[orig], is a
splitter: the segments between consecutive splitters partition the cycle.
  sort     tvec from one torch.sort of the unique int64 keys
           (last << 21) | idx, packed as w = tvec << 8 | last
  pass 1   chain c walks from its splitter (node c * SEG, or the start
           node) to the next one: its length and successor chain
  stitch   each block follows the successors from the start chain,
           giving every chain its output offset; a block whose walk does
           not visit every live chain once and cover n bytes is flagged
           (a periodic block: its LF map has several cycles)
  pass 2   every chain walks again and writes its bytes at its offset
The three steps after the sort are the CUDA kernels of csrc/ibwt_walk.cu
on a card. The TPU design's slot streams, their cap (CAP) and the
placement sort do not carry over: chain offsets come from the stitch, so
no block is declined for capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch.kernels.deflate_pipeline import _device, _nohook

MAX_N = 1 << 21           # keys hold the index in 21 bits
STITCH_SMEM = 232448      # a block's shared memory on Hopper: the stitch
                          # holds 3 int32 per chain there
# Splitter stride, below the reference's _seg_for(N) (2048 at N = 2^20): a
# pass lasts as long as its longest chain, about ln(chains) x SEG steps,
# so a shorter stride shortens that tail, while the stitch, serial in a
# block's chains, grows as it shrinks. At the bzip2 decode headline 128 is
# 6x faster than 2048 and within 0.4 ms of 64 (ibwt_stride.py; PERF.md),
# and unlike 64 its stitch fits shared memory at every N up to MAX_N
# (16,385 chains a block).
IBWT_SEG = 128


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


def ibwt(w, start_g, length, seg: int):
    """The iBWT walk: the plain version for CPU tensors, the CUDA kernels
    (csrc/ibwt_walk.cu: pass 1, stitch, pass 2) for CUDA tensors.
    Arguments and results as ibwt_walk_plain; all int32 and contiguous."""
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
    if 3 * 4 * KC > STITCH_SMEM:
        raise ValueError(f"ibwt: {KC} chains a block (seg {seg}) exceed the "
                         "stitch's shared memory")
    out = torch.zeros((NB, N), dtype=torch.uint8, device=w.device)
    flag = torch.zeros(NB, dtype=torch.int32, device=w.device)
    scratch = torch.empty((3, NB, KC), dtype=torch.int32, device=w.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(w.device):
        rc = _build.lib().tpz_ibwt_walk(
            w.data_ptr(), start_g.data_ptr(), length.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), flag.data_ptr(), NB, N, m,
            KC, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ibwt kernel launch failed: cudaError {rc}")
    ibwt.launches += 1
    return out, flag


ibwt.launches = 0


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
    w, start_g, length, valid = lf_inputs(last, length, orig)
    stage_hook("sort")
    out, flag = ibwt(w, start_g, length, seg)
    stage_hook("ibwt")
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
