"""The parse walks: greedy/lazy LZSS parse with match extension (port of
tpz/kernels/parse.py).

Spec v1 (LZHUF encode; the walk `parse_extend_pallas` runs on the TPU):
one walk per block from position 0, each token's length the winner
candidate's match extended by 4-byte compares. `parse_extend_v1_plain` is
the plain torch version, `parse_extend_v1` the wrapper (CUDA kernel
`tpz_torch/csrc/parse_v1_walk.cu` on a card). See parse_extend_v1_plain.

Spec v3 (DEFLATE encode; `_v3_marks`, `parse_extend_v3z`, and the walk
that `parse_extend_pallas_v3y` runs on the TPU):

Every `restart`-sized sub-range of a block is parsed by an independent
state machine (a "sub-walk"). An unsaturated token's outcome is a pure
function of its screen word, precomputed by `_v3_marks`; saturated
positions take the extension machinery (4-byte compares against the
candidate, then optionally the second candidate).

- `parse_extend_v3z` is the plain torch version: all sub-walks advance
  together, one micro-step per trip of a Python loop.
- `parse_extend_v3` is the wrapper the pipeline calls: a CPU tensor runs
  the plain version, a CUDA tensor launches the hand-written kernel in
  `tpz_torch/csrc/parse_walk.cu`.

`n_extend` is the oracle's parameter of the same name (cpp/lzss.h): with
2, a saturated second candidate is extended when the first falls short of
the cap. The reference walks never load that candidate, so they equal the
oracle run with n_extend=1; the port takes both values so it can be held
exactly against either.

Outputs (visited, mlen, mdist) are [NB, N] int32: visited = mlen + 1 at
every position where a token starts, 0 elsewhere.

Spec v3, interleaved (the reference's parse_extend_pallas_v3w; no codec
path calls it, in either package): the same walk reading the raw screen
words, without marks or cap_at. `parse_extend_v3w_plain` is the plain
version, `parse_extend_v3w` the wrapper (CUDA kernel
`tpz_torch/csrc/parse_v3w_walk.cu` on a card).

Greedy reach (the reference's greedy_parse and its _parse_pallas; no
codec path calls them either): `greedy_parse` follows p -> p + step(p)
through `reach_walk`, whose plain version is the pointer doubling
`_reach_doubling` and whose kernel is `tpz_torch/csrc/reach_walk.cu`.
"""

from __future__ import annotations

import torch

from tpz_torch.utils.bits import U32

RAW = 1 << 30
SENT = 1 << 20
SMASK = (1 << 20) - 1


def _v3_marks(pk1, pk2, cap_at, block_len, window, max_match,
              screen_bytes, too_far, lazy, max_lazy):
    """Ready-to-emit marks [NB, N] int32: (dist << 10) | (len + 1) for a
    match, (raw len << 10) | 1 for a literal or lazily demoted match.
    Saturated positions, and lazy probes over a saturated neighbour,
    carry the raw screen word plus the RAW flag bit instead.
    block_len: [NB] int32."""
    NB, N = pk1.shape
    pos = torch.arange(N, device=pk1.device, dtype=torch.int32).expand(NB, N)
    blen = block_len[:, None]
    ss1p = (pk1 & 63) - 1
    jj1p = (pk1 >> 6) - 1
    scapp = torch.clamp(cap_at, max=screen_bytes)
    satp = (ss1p >= scapp) & (jj1p >= 0)
    no1p = (jj1p < 0) | (ss1p < 3)
    lnp = torch.where(no1p, 0, ss1p)
    distp = pos + window - jj1p
    lnp = torch.where((lnp == 3) & (distp > too_far), 0, lnp)
    distp = torch.where(lnp > 0, distp, 0)
    if lazy:
        ln_next = torch.nn.functional.pad(lnp[:, 1:], (0, 1))
        sat_next = torch.nn.functional.pad(satp[:, 1:], (0, 1))
        probe_would = (lnp > 0) & (lnp < max_lazy) & (pos + 1 < blen)
        demote = probe_would & ~sat_next & (ln_next > lnp)
        flagged = satp | (probe_would & sat_next)
    else:
        demote = torch.zeros_like(satp)
        flagged = satp
    markp = torch.where(demote | (lnp == 0), (lnp << 10) | 1,
                        (distp << 10) | (lnp + 1))
    return torch.where(flagged, pk1 | RAW, markp)


def _outputs(out: torch.Tensor):
    visited = out & 1023
    mlen = torch.clamp(visited - 1, min=0)
    mdist = torch.where(mlen > 0, out >> 10, 0)
    return visited, mlen, mdist


def _lzbytes(x):
    """Equal low-order bytes of a nonzero xor (0..3)."""
    return (((x & 0xFF) == 0).to(torch.int32)
            + ((x & 0xFFFF) == 0).to(torch.int32)
            + ((x & 0xFFFFFF) == 0).to(torch.int32))


def _parse_extend_v3z_core(pk1, pk2, cap_at, words, block_len, window,
                           max_match, screen_bytes, too_far, lazy, max_lazy,
                           restart, n_extend):
    """Lane-parallel walk over all NB * (N / restart) sub-walks at once:
    one trip of the loop advances every live sub-walk by one micro-step
    (one 8-byte compare in EXT). A run of literals is painted in one trip
    from jump lengths baked into the literal marks' spare bits 19..29."""
    NB, N = pk1.shape
    M = words.shape[1]
    dev = pk1.device
    if not restart or restart >= N:
        restart = N
    assert N % restart == 0
    nsub = N // restart
    NW = NB * nsub

    w1 = _v3_marks(pk1, pk2, cap_at, block_len, window, max_match,
                   screen_bytes, too_far, lazy, max_lazy)
    pos = torch.arange(N, device=dev, dtype=torch.int32).expand(NB, N)
    interesting = ((w1 & RAW) != 0) | ((w1 & 1023) >= 2)
    nxt = torch.where(interesting, pos, 1 << 28)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    jump = torch.clamp(nxt - pos, 1, 2047)
    w1 = torch.where(interesting, w1, w1 | (jump << 19))
    # One flat buffer per block, [marks/pk2 interleaved (2N) | words (M)],
    # so each trip's four reads are one gather.
    mp = torch.stack([w1, pk2], dim=2).reshape(NB, 2 * N)
    comb = torch.cat([mp, words], dim=1).reshape(-1)
    R = 2 * N + M
    WOFF = 2 * N

    wid = torch.arange(NW, device=dev, dtype=torch.int32)
    blk_w = wid // nsub
    sub_w = wid % nsub
    base_w = blk_w.to(torch.int64) * R
    blen_w = block_len[blk_w]
    pend_w = torch.minimum((sub_w + 1) * restart, blen_w)
    zero = torch.zeros(NW, device=dev, dtype=torch.int32)
    p = sub_w * restart
    st = tgt = cand = k = j = scap = nz = res1 = jres1 = ln0 = dist0 = zero
    cap = zero + 1
    s2v = j2v = zero - 1
    # Marks are STORED (each position is emitted at most once); literal
    # runs add +1/-1 interval deltas. Junk lanes land on a spare slot.
    out = torch.zeros(NB * (N + 1), device=dev, dtype=torch.int32)
    delta = torch.zeros(NB * (N + 2), device=dev, dtype=torch.int32)
    out_row = blk_w.to(torch.int64) * (N + 1)
    d_row = blk_w.to(torch.int64) * (N + 2)

    while True:
        act = p < pend_w
        if not bool(act.any()):
            break
        is_ext = act & (st == 1)
        is_tok = act & (st == 0)

        q = p + tgt
        qc = torch.clamp(q, max=N - 1)
        ea = torch.clamp(q + window + k, max=M - 1)
        eb = torch.clamp(j + k, 0, M - 1)
        ea2 = torch.clamp(ea + 4, max=M - 1)
        eb2 = torch.clamp(eb + 4, max=M - 1)
        offs = torch.cat([
            torch.where(is_ext, WOFF + ea, 2 * qc),
            torch.where(is_ext, WOFF + eb, 2 * qc + 1),
            torch.where(is_ext, WOFF + ea2, 2 * qc),
            torch.where(is_ext, WOFF + eb2, 2 * qc + 1)]).to(torch.int64)
        g4 = comb[offs + base_w.repeat(4)]
        a, b, a2, b2 = g4[:NW], g4[NW:2 * NW], g4[2 * NW:3 * NW], g4[3 * NW:]

        rawq = (a & RAW) != 0
        apk = a & (RAW - 1)
        fast0 = is_tok & ~rawq & (tgt == 0)
        fast1 = is_tok & ~rawq & (tgt == 1)
        aln = apk & 1023
        amark_ln = torch.where(aln == 1, (apk >> 10) & 511, aln - 1)
        lit0 = fast0 & (aln == 1)
        q_to = torch.minimum(p + torch.clamp((apk >> 19) & 2047, min=1),
                             pend_w)

        # ---- TOK (raw): unpack screen candidates at q ----
        ss1 = (apk & 63) - 1
        jj1 = (apk >> 6) - 1
        cap_t = torch.clamp(blen_w - q, max=max_match)
        cap_t = torch.minimum(cap_t, restart - (q % restart))
        scap_t = torch.clamp(cap_t, max=screen_bytes)
        no1 = (jj1 < 0) | (ss1 < 3)
        sat1 = (ss1 >= scap_t) & (jj1 >= 0)
        go_ext = is_tok & rawq & sat1
        fin_tok = is_tok & rawq & ~sat1

        # ---- EXT: one 8-byte compare step (two 4-byte words) ----
        x = a ^ b
        x2 = a2 ^ b2
        full8 = (x == 0) & (x2 == 0)
        adv = torch.where(x != 0, _lzbytes(x),
                          4 + torch.where(x2 == 0, 4, _lzbytes(x2)))
        k2 = torch.minimum(k + adv, cap)
        kn = torch.where(full8, k2, k2 + SENT)
        edone = is_ext & (kn >= cap)
        lnc = torch.minimum(kn & SMASK, cap)
        need2 = (j2v >= 0) & (s2v >= scap) & (lnc < cap)
        b_to2 = edone & (cand == 1) & need2
        b_fin1 = edone & (cand == 1) & ~need2
        b_fin2 = edone & (cand == 2)
        use2 = lnc > res1

        # ---- FIN: rules, lazy, emit ----
        fin_now = fin_tok | b_fin1 | b_fin2 | fast1
        lnf = torch.where(fin_tok, ss1,
                          torch.where(b_fin2, torch.maximum(lnc, res1), lnc))
        jf = torch.where(fin_tok, jj1,
                         torch.where(b_fin2 & ~use2, jres1, j))
        nzv = torch.where(fin_tok, no1, nz != 0)
        lnf = torch.where(nzv, 0, lnf)
        distf = q + window - jf
        lnf = torch.where((lnf == 3) & (distf > too_far), 0, lnf)
        distf = torch.where(lnf > 0, distf, 0)
        lnf = torch.where(fast1, amark_ln, lnf)

        if lazy:
            golazy = (fin_now & (tgt == 0) & (lnf > 0) & (lnf < max_lazy)
                      & (p + 1 < blen_w))
        else:
            golazy = torch.zeros_like(fin_now)
        do_emit = (fin_now & ~golazy) | fast0
        demote = lnf > ln0
        lnE = torch.where(tgt == 0, lnf, torch.where(demote, 0, ln0))
        dE = torch.where(tgt == 0, distf, torch.where(demote, 0, dist0))
        mark = torch.where(fast0, apk, (dE << 10) | (lnE + 1))
        adv_p = torch.where(lit0, q_to - p,
                            torch.where(fast0, torch.clamp(aln - 1, min=1),
                                        torch.clamp(lnE, min=1)))

        # ---- next state ----
        if n_extend >= 2:
            s2v = torch.where(go_ext, (b & 63) - 1, s2v)
            j2v = torch.where(go_ext, (b >> 6) - 1, j2v)
        st = torch.where(go_ext | b_to2, 1, torch.where(fin_now, 0, st))
        tgt = torch.where(golazy, 1, torch.where(do_emit, 0, tgt))
        cand = torch.where(go_ext, 1, torch.where(b_to2, 2, cand))
        k = torch.where(go_ext, ss1, torch.where(
            b_to2, s2v, torch.where(is_ext & ~edone, kn, k)))
        res1 = torch.where(b_to2, lnc, res1)
        jres1 = torch.where(b_to2, j, jres1)
        j = torch.where(go_ext, jj1, torch.where(b_to2, j2v, j))
        cap = torch.where(go_ext, cap_t, cap)
        scap = torch.where(go_ext, scap_t, scap)
        nz = torch.where(go_ext, no1.to(torch.int32), nz)
        ln0 = torch.where(golazy, lnf, ln0)
        dist0 = torch.where(golazy, distf, dist0)

        emit_pt = do_emit & ~lit0
        out.index_put_((torch.where(emit_pt, out_row + p, out_row + N),),
                       mark)
        delta.index_add_(0, torch.cat([
            torch.where(lit0, d_row + p, d_row + N + 1),
            torch.where(lit0, d_row + q_to, d_row + N + 1)]),
            torch.cat([lit0.to(torch.int32), -lit0.to(torch.int32)]))
        p = torch.where(do_emit, p + adv_p, p)

    out = out.reshape(NB, N + 1)[:, :N]
    interval = torch.cumsum(delta.reshape(NB, N + 2)[:, :N], dim=1) > 0
    return _outputs(torch.where(interval, w1, out))


def parse_extend_v3z(pk1, pk2, cap_at, words, block_len, window,
                     max_match=258, screen_bytes=16, too_far=4096,
                     lazy=False, max_lazy=258, restart=0, n_extend=2,
                     group=16):
    """Plain torch version of the parse walk. pk1, pk2, cap_at: [NB, N]
    int32 block-local screen outputs; words: [NB, M] int32; block_len:
    [NB] int32. Blocks run in groups of `group` to bound the loop's
    working set; the result does not depend on it."""
    NB = pk1.shape[0]
    parts = [_parse_extend_v3z_core(
        pk1[g:g + group], pk2[g:g + group], cap_at[g:g + group],
        words[g:g + group], block_len[g:g + group], window, max_match,
        screen_bytes, too_far, lazy, max_lazy, restart, n_extend)
        for g in range(0, NB, group)]
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(x, dim=0) for x in zip(*parts))


def parse_extend_v3(pk1, pk2, cap_at, words, block_len, window,
                    max_match=258, screen_bytes=16, too_far=4096,
                    lazy=False, max_lazy=258, restart=0, n_extend=2,
                    group=16):
    """The parse walk: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (`group` applies to the plain version only)."""
    if pk1.device.type == "cpu":
        return parse_extend_v3z(pk1, pk2, cap_at, words, block_len, window,
                                max_match, screen_bytes, too_far, lazy,
                                max_lazy, restart, n_extend, group)
    if pk1.device.type != "cuda":
        raise ValueError(f"parse walk: unsupported device {pk1.device}")
    NB, N = pk1.shape
    M = words.shape[1]
    if not restart or restart >= N:
        restart = N
    for name, t, shape in (("pk1", pk1, (NB, N)), ("pk2", pk2, (NB, N)),
                           ("cap_at", cap_at, (NB, N)),
                           ("words", words, (NB, M)),
                           ("block_len", block_len, (NB,))):
        if (t.device != pk1.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"parse walk: {name} must be a contiguous int32 CUDA tensor "
                f"of shape {shape} on {pk1.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if N % restart or M < N + window + max_match:
        raise ValueError(f"parse walk: bad geometry N={N} M={M} "
                         f"restart={restart} window={window}")
    w1 = _v3_marks(pk1, pk2, cap_at, block_len, window, max_match,
                   screen_bytes, too_far, lazy, max_lazy)
    out = torch.zeros((NB, N), dtype=torch.int32, device=pk1.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(pk1.device):
        rc = _build.lib().tpz_parse_walk_v3(
            w1.data_ptr(), pk2.data_ptr(), words.data_ptr(),
            block_len.data_ptr(), out.data_ptr(), NB, N, M, window,
            restart, max_match, screen_bytes, too_far, int(lazy), max_lazy,
            n_extend, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parse walk kernel launch failed: cudaError {rc}")
    parse_extend_v3.launches += 1
    return _outputs(out)


parse_extend_v3.launches = 0


def _v3w_cap_at(block_len, N, max_match, restart):
    """The cap v3w's state machine computes at every position q:
    min(max_match, block_len - q, restart - q mod restart)."""
    pos = torch.arange(N, device=block_len.device, dtype=torch.int32)
    return torch.minimum(torch.clamp(block_len[:, None] - pos, max=max_match),
                         restart - pos % restart)


def parse_extend_v3w_plain(pk1, pk2, words, block_len, window,
                           max_match=258, screen_bytes=16, too_far=4096,
                           lazy=False, max_lazy=258, restart=0, group=16):
    """The plain version of the interleaved spec-v3 walk (the reference's
    parse_extend_pallas_v3w): the walk reads the raw screen words, with no
    mark precompute and no cap_at input. Its cap is a function of the
    position alone, so it is derived here as v3w derives it, and the
    walk is the v3z core at n_extend=1: v3w never loads the second
    candidate (its s2v/j2v stay 0, and the cap is at least 1, so the
    candidate-2 branch is never taken; R4). No sub-walk reaches past
    block_len, so every output is 0 there, as v3w's."""
    NB, N = pk1.shape
    if not restart or restart >= N:
        restart = N
    cap_at = _v3w_cap_at(block_len, N, max_match, restart)
    return parse_extend_v3z(pk1, pk2, cap_at, words, block_len, window,
                            max_match, screen_bytes, too_far, lazy, max_lazy,
                            restart, n_extend=1, group=group)


def parse_extend_v3w(pk1, pk2, words, block_len, window, max_match=258,
                     screen_bytes=16, too_far=4096, lazy=False, max_lazy=258,
                     restart=0):
    """The interleaved spec-v3 walk: the plain version for CPU tensors, the
    CUDA kernel (csrc/parse_v3w_walk.cu, one thread per restart sub-walk)
    for CUDA tensors. pk1, pk2 [NB, N] int32 block-local screen words;
    words [NB, M] int32; block_len [NB] int32; all contiguous. Returns
    (visited, mlen, mdist) [NB, N] int32. The reference's nblk (blocks per
    grid step) and W (sub-walks interleaved in one kernel body) only
    spread its walks over a TPU core and change no result: they have no
    counterpart."""
    if pk1.device.type == "cpu":
        return parse_extend_v3w_plain(pk1, pk2, words, block_len, window,
                                      max_match, screen_bytes, too_far, lazy,
                                      max_lazy, restart)
    if pk1.device.type != "cuda":
        raise ValueError(f"v3w parse walk: unsupported device {pk1.device}")
    NB, N = pk1.shape
    M = words.shape[1]
    if not restart or restart >= N:
        restart = N
    for name, t, shape in (("pk1", pk1, (NB, N)), ("pk2", pk2, (NB, N)),
                           ("words", words, (NB, M)),
                           ("block_len", block_len, (NB,))):
        if (t.device != pk1.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"v3w parse walk: {name} must be a contiguous int32 tensor "
                f"of shape {shape} on {pk1.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if N % restart or M < N + window + max_match:
        raise ValueError(f"v3w parse walk: bad geometry N={N} M={M} "
                         f"restart={restart} window={window}")
    out = torch.zeros((NB, N), dtype=torch.int32, device=pk1.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(pk1.device):
        rc = _build.lib().tpz_parse_v3w_walk(
            pk1.data_ptr(), words.data_ptr(), block_len.data_ptr(),
            out.data_ptr(), NB, N, M, window, restart, max_match,
            screen_bytes, too_far, int(lazy), max_lazy,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"v3w parse walk kernel launch failed: cudaError {rc}")
    parse_extend_v3w.launches += 1
    return _outputs(out)


parse_extend_v3w.launches = 0


# ------------------------------------------------------------ greedy reach

MIN_MATCH = 3


def reach_walk(step: torch.Tensor) -> torch.Tensor:
    """The greedy reach mask (the reference's _parse_pallas): follow p ->
    p + step[p] from p = 0 while p < N. step [NB, N] int32 (a step below 1
    counts as 1) -> [NB, N] int32, 1 at every position the chain visits.
    A CPU tensor runs the pointer doubling (_reach_doubling), a CUDA
    tensor the kernel csrc/reach_walk.cu (one thread per row)."""
    if step.device.type == "cpu":
        return _reach_doubling(torch.clamp(step.to(torch.int64),
                                           min=1)).to(torch.int32)
    if step.device.type != "cuda":
        raise ValueError(f"reach walk: unsupported device {step.device}")
    if step.dtype != torch.int32 or step.dim() != 2 or not step.is_contiguous():
        raise ValueError(f"reach walk: step must be a contiguous [NB, N] "
                         f"int32 tensor, got {step.dtype} {tuple(step.shape)}")
    NB, N = step.shape
    out = torch.zeros((NB, N), dtype=torch.int32, device=step.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(step.device):
        rc = _build.lib().tpz_reach_walk(
            step.data_ptr(), out.data_ptr(), NB, N,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"reach walk kernel launch failed: cudaError {rc}")
    reach_walk.launches += 1
    return out


reach_walk.launches = 0


def greedy_parse(match_len, match_dist, block_len):
    """The greedy parse over per-position matches (the reference's
    greedy_parse): match_len [NB, N] int32 (0 where no match; match_dist
    is not read, as in the reference), block_len [NB] int32. Returns
    (is_token [NB, N] bool, token_idx [NB, N] int32 dense token index,
    valid where is_token, ntokens [NB] int32). The reference's use_pallas
    has no counterpart: the device of match_len picks the route, as in
    reach_walk."""
    NB, N = match_len.shape
    pos = torch.arange(N, device=match_len.device, dtype=torch.int32)
    step = torch.where(match_len >= MIN_MATCH, match_len, 1).to(torch.int32)
    is_token = (reach_walk(step.contiguous()) > 0) & (pos < block_len[:, None])
    cum = torch.cumsum(is_token, dim=1, dtype=torch.int32)
    return is_token, cum - 1, cum[:, -1]


# ------------------------------------------------------------ spec v1

def parse_extend_v1_plain(screen, best_j, words, block_len, window: int,
                          max_match: int = 258, too_far: int = 4096,
                          lazy: bool = False):
    """The plain version of the spec-v1 parse walk.

    screen, best_j [NB, N] int32: the v1 screen's clamped 8-byte match
    and winner M-index (-1 = none) at each block position; words [NB, M]
    int32 4-byte windows (M-index = block position + window); block_len
    [NB] int32. Returns (reach, mlen) [NB, N] int32: reach = len + 1 at
    every position the walk visits, 0 elsewhere; mlen = max(reach - 1, 0).

    The walk visits p, takes its length ln(p), and goes on at
    p + max(ln(p), 1) until p >= N (past block_len too, as the reference
    does). Every quantity of ln(p) depends on p alone, so the plain
    version needs no token loop: it computes ln at every position (the
    extension of saturated screens runs over those positions at once, at
    most 64 word compares), applies the one-step lazy rule (a literal at
    p when ln(p + 1) > ln(p)), and finds the visited positions by pointer
    doubling over the steps, as the reference's `_parse_doubling`."""
    NB, N = screen.shape
    M = words.shape[1]
    dev = screen.device
    pos = torch.arange(N, device=dev, dtype=torch.int64)[None, :]
    blen = block_len.to(torch.int64)[:, None]
    # The reference packs the screen as clip(screen + 1, 0, 9).
    s = (torch.clamp(screen + 1, 0, 9) - 1).to(torch.int64)
    j = best_j.to(torch.int64)
    cap = torch.clamp(blen - pos, max=max_match)
    ln = s.clone()
    ext = (s >= 3) & (s >= torch.clamp(cap, max=8))
    rows, cols = torch.nonzero(ext, as_tuple=True)
    if rows.numel():
        # Extension: k starts at the screen and grows by the equal bytes of
        # 4-byte compares until a mismatch or the cap.
        wflat = words.reshape(-1).to(torch.int64)
        base = rows * M
        a0 = cols + window
        jb = j[rows, cols]
        k = s[rows, cols]
        kcap = cap[rows, cols]
        live = k < kcap
        while bool(live.any()):
            x = (wflat[base + torch.clamp(a0 + k, 0, M - 1)]
                 ^ wflat[base + torch.clamp(jb + k, 0, M - 1)]) & U32
            eq = (((x & 0xFF) == 0).to(torch.int64)
                  + ((x & 0xFFFF) == 0).to(torch.int64)
                  + ((x & 0xFFFFFF) == 0).to(torch.int64))
            k = torch.where(live, torch.minimum(
                k + torch.where(x == 0, 4, eq), kcap), k)
            live = live & (x == 0) & (k < kcap)
        ln[rows, cols] = torch.minimum(k, kcap)
    ln = torch.where(s < 3, 0, ln)
    dist = pos + window - j
    ln = torch.where((ln == 3) & (dist > too_far), 0, ln)
    ln = torch.where(j < 0, 0, ln)
    if lazy:
        nxt = torch.nn.functional.pad(ln[:, 1:], (0, 1))
        ln = torch.where((ln > 0) & (pos + 1 < blen) & (nxt > ln), 0, ln)

    visited = _reach_doubling(torch.clamp(ln, min=1))
    reach = torch.where(visited, ln + 1, 0).to(torch.int32)
    return reach, torch.clamp(reach - 1, min=0)


def _reach_doubling(step: torch.Tensor) -> torch.Tensor:
    """[NB, N] int64 steps >= 1 -> [NB, N] bool: the positions of the
    chain 0 -> p + step(p) -> ... below N (the reference's
    _parse_doubling: S_{r+1} = S_r | f_{2^r}(S_r), f_{2^{r+1}} = f_{2^r}
    after itself)."""
    NB, N = step.shape
    pos = torch.arange(N, device=step.device, dtype=torch.int64)[None, :]
    f = torch.cat([torch.clamp(pos + step, max=N),
                   torch.full((NB, 1), N, dtype=torch.int64,
                              device=step.device)], dim=1)
    reach = torch.zeros((NB, N + 1), dtype=torch.int32, device=step.device)
    reach[:, 0] = 1
    for _ in range(N.bit_length()):
        reach = reach.scatter_reduce(1, f, reach, reduce="amax")
        f = f.gather(1, f)
    return reach[:, :N] > 0


def parse_extend_v1(screen, best_j, words, block_len, window: int,
                    max_match: int = 258, too_far: int = 4096,
                    lazy: bool = False):
    """The spec-v1 parse walk: the plain version for CPU tensors, the
    CUDA kernel (csrc/parse_v1_walk.cu, one thread per block) for CUDA
    tensors. Arguments and results as parse_extend_v1_plain; all int32
    and contiguous."""
    if screen.device.type == "cpu":
        return parse_extend_v1_plain(screen, best_j, words, block_len,
                                     window, max_match, too_far, lazy)
    if screen.device.type != "cuda":
        raise ValueError(f"v1 parse walk: unsupported device {screen.device}")
    NB, N = screen.shape
    M = words.shape[1]
    for name, t, shape in (("screen", screen, (NB, N)),
                           ("best_j", best_j, (NB, N)),
                           ("words", words, (NB, M)),
                           ("block_len", block_len, (NB,))):
        if (t.device != screen.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"v1 parse walk: {name} must be a contiguous int32 tensor "
                f"of shape {shape} on {screen.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    out = torch.zeros((NB, N), dtype=torch.int32, device=screen.device)
    from tpz_torch.kernels import _build

    with torch.cuda.device(screen.device):
        rc = _build.lib().tpz_parse_v1_walk(
            screen.data_ptr(), best_j.data_ptr(), words.data_ptr(),
            block_len.data_ptr(), out.data_ptr(), NB, N, M, window,
            max_match, too_far, int(lazy),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"v1 parse walk kernel launch failed: cudaError {rc}")
    parse_extend_v1.launches += 1
    return out, torch.clamp(out - 1, min=0)


parse_extend_v1.launches = 0
