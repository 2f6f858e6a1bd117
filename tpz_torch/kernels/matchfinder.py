"""Match-candidate screening in torch (port of tpz/kernels/matchfinder.py).

Spec v3 (DEFLATE, `suffix_screen_w` / `suffix_screen_w_chunked`): every
insertable position is sorted by its `screen_bytes`-byte big-endian
prefix; each position then scans `r_neighbors` sorted neighbours in each
direction and keeps the top-2 candidates by (clamped screen, recency).

Spec v1 (LZHUF, `screen_candidates` / `screen_candidates_w`): positions
are sorted by (3-byte hash, position), so each position's K most recent
same-hash predecessors are its K sorted-order neighbours; each is scored
by its clamped 8-byte match and the best (ties to the most recent) wins.
The LZHUF codec's route is the screen, then the v1 parse walk
(kernels/parse.py). `find_matches` extends the screen's winner to its
full match with prefix-doubling rank arrays (`build_ranks`,
`lcp_from_ranks`); its one caller is the sharded encode step
(parallel/mesh.py).

The outputs are bit-identical to the reference's. Words arrive as int32
bit patterns of u32 little-endian 4-byte windows.
"""

from __future__ import annotations

import torch

from tpz_torch.utils.bits import U32, as_u32, srl32, to_i32

WINDOW = 32768
BLOCK = 65536
FWD_PAD = 512          # forward pad: max_match rounded up + screen slack
M_TOTAL = WINDOW + BLOCK + FWD_PAD
MAX_MATCH = 258
MIN_MATCH = 3
TOO_FAR = 4096
HASH_BITS = 15
RANK_LEVELS = (4, 8, 16, 32, 64, 128, 256)

_I32_MIN = -(1 << 31)


def _bswap32(x: torch.Tensor) -> torch.Tensor:
    """Byte swap of int32 bit patterns."""
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | srl32(x, 24))


def _eq_bytes_be(x: torch.Tensor) -> torch.Tensor:
    """Leading equal BYTES (0..4) from a big-endian xor value given as an
    int32 bit pattern: unsigned `x < 2^k` is `0 <= x < 2^k` in int32."""
    nonneg = x >= 0
    return ((nonneg & (x < (1 << 24))).to(torch.int32)
            + (nonneg & (x < (1 << 16))).to(torch.int32)
            + (nonneg & (x < (1 << 8))).to(torch.int32)
            + (x == 0).to(torch.int32))


def _sort_perm(keys: list[torch.Tensor], flag: torch.Tensor) -> torch.Tensor:
    """Row-wise permutation sorting by (flag, keys[0], ..., keys[-1], idx),
    each key compared as UNSIGNED 32 bits (H4: torch has no multi-key
    sort). Chained stable sorts run from the least significant key to the
    most; the identity start supplies the final `idx` tie-break. Two u32
    keys pack into one int64 (the high one sign-flipped), halving the
    sorts; sorting an int32 key as signed would put every key with a
    leading byte >= 0x80 first."""
    NB, M = flag.shape
    perm = torch.arange(M, device=flag.device,
                        dtype=torch.int64).expand(NB, M)
    t = len(keys)
    while t > 0:
        lo = as_u32(keys[t - 1])
        if t >= 2:
            hi = (keys[t - 2] ^ _I32_MIN).to(torch.int64)
            k = hi * (1 << 32) + lo
            t -= 2
        else:
            k = lo
            t -= 1
        _, o = torch.sort(k.gather(1, perm), dim=1, stable=True)
        perm = perm.gather(1, o)
    _, o = torch.sort(flag.gather(1, perm), dim=1, stable=True)
    return perm.gather(1, o)


def screen_caps(pos: torch.Tensor, span_off: torch.Tensor,
                span_len: torch.Tensor, window: int, block: int,
                max_match: int, restart: int) -> torch.Tensor:
    """Per-position match cap at M-index `pos` ([NB, M]): bounded by the
    block end, the buffer end, max_match and the restart sub-boundary;
    0 in the halo."""
    block_end_rel = torch.clamp(window + (span_len - span_off)[:, None],
                                max=block + window)
    cap = torch.clamp(block_end_rel - pos, 0, max_match)
    if restart:
        # Parse-restart rule (cpp/lzss.h LzssParams.restart): no match may
        # cross a restart-aligned sub-boundary within the block.
        cap = torch.minimum(cap, restart - ((pos - window) & (restart - 1)))
    return torch.where(pos >= window, cap, 0)


def suffix_screen_w(words: torch.Tensor, span_off: torch.Tensor,
                    span_len: torch.Tensor, r_neighbors: int, window: int,
                    block: int, max_match: int, screen_bytes: int,
                    restart: int = 0):
    """words [NB, M] int32; span_off, span_len [NB] int32 (each block's
    offset in its buffer, and that buffer's length).

    Returns (pk1, pk2, cap_at), all [NB, M] int32 in position order. pk
    packs a candidate as ((j + 1) << 6) | (s + 1): j its M-index, s its
    LCP clamped to min(screen_bytes, cap)."""
    NB, M = words.shape
    dev = words.device
    if restart:
        assert restart & (restart - 1) == 0 and block % restart == 0
    nw = screen_bytes // 4
    idx = torch.arange(M, device=dev, dtype=torch.int32).expand(NB, M)
    gpos = span_off[:, None] + (idx - window)
    insertable = ((gpos >= 0) & (gpos + MIN_MATCH <= span_len[:, None])
                  & (idx < window + block))
    cap_at = screen_caps(idx, span_off, span_len, window, block, max_match,
                         restart)

    wbe = _bswap32(words)
    keys = [torch.roll(wbe, -4 * t, dims=1) for t in range(nw)]
    flag = (~insertable).to(torch.int32)
    perm = _sort_perm(keys, flag)
    spos = perm.to(torch.int32)
    skeys = [k.gather(1, perm) for k in keys]
    sval = insertable.gather(1, perm)
    # cap in sorted order is a pure function of spos.
    scap = screen_caps(spos, span_off, span_len, window, block, max_match,
                       restart)
    screen_cap = torch.clamp(scap, max=screen_bytes)

    col = idx
    j1 = torch.full((NB, M), -1, dtype=torch.int32, device=dev)
    s1 = j1.clone()
    j2 = j1.clone()
    s2 = j1.clone()
    for sign in (1, -1):
        for kk in range(1, r_neighbors + 1):
            sh = sign * kk
            pp = torch.roll(spos, sh, dims=1)
            pv = torch.roll(sval, sh, dims=1)
            in_bounds = (col >= kk) if sign > 0 else (col < M - kk)
            ok = (in_bounds & pv & sval & (pp < spos)
                  & (spos - pp <= window))
            # LCP from the BE key words, chained while saturated.
            s = torch.zeros((NB, M), dtype=torch.int32, device=dev)
            carry = torch.ones((NB, M), dtype=torch.bool, device=dev)
            for t in range(nw):
                eq = _eq_bytes_be(skeys[t] ^ torch.roll(skeys[t], sh, dims=1))
                s = s + torch.where(carry, eq, 0)
                carry = carry & (eq == 4)
            s = torch.where(ok, torch.minimum(s, screen_cap), -1)
            # top-2 by (screen, recency): a strict total order since
            # positions are unique.
            beats1 = (s > s1) | ((s == s1) & (pp > j1))
            beats2 = (s > s2) | ((s == s2) & (pp > j2))
            j2 = torch.where(beats1, j1, torch.where(beats2, pp, j2))
            s2 = torch.where(beats1, s1, torch.where(beats2, s, s2))
            j1 = torch.where(beats1, pp, j1)
            s1 = torch.where(beats1, s, s1)

    pk1 = torch.where(j1 >= 0, ((j1 + 1) << 6) | (s1 + 1), 0)
    pk2 = torch.where(j2 >= 0, ((j2 + 1) << 6) | (s2 + 1), 0)
    # Back to position order: spos is a permutation of 0..M-1.
    opk1 = torch.empty_like(pk1).scatter_(1, perm, pk1)
    opk2 = torch.empty_like(pk2).scatter_(1, perm, pk2)
    return opk1, opk2, cap_at


def suffix_screen_w_chunked(words, span_off, span_len, r_neighbors,
                            window, block, max_match, screen_bytes,
                            restart: int = 0, chunk: int = 64):
    """suffix_screen_w over groups of `chunk` rows (rows are independent),
    bounding the sort's working set. Bit-identical to the unchunked
    screen."""
    NB = words.shape[0]
    outs = [suffix_screen_w(words[r:r + chunk], span_off[r:r + chunk],
                            span_len[r:r + chunk], r_neighbors, window,
                            block, max_match, screen_bytes, restart)
            for r in range(0, NB, chunk)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts, dim=0) for parts in zip(*outs))


# ------------------------------------------------------------ spec v1

def hash3(words: torch.Tensor) -> torch.Tensor:
    """Hash of the low 3 bytes of each word (int32 bit patterns), as
    cpp/lzss.cc Hash3: (v * 0x9E3779B1 mod 2^32) >> (32 - HASH_BITS).
    Returns int64 in [0, 2^HASH_BITS)."""
    v = words.to(torch.int64) & 0x00FFFFFF
    return ((v * 0x9E3779B1) & U32) >> (32 - HASH_BITS)


def words_at(data: torch.Tensor) -> torch.Tensor:
    """data [NB, M] byte values (any integer type) -> int32 bit patterns
    of the u32 little-endian 4-byte window at every offset. The windows
    of a row's last three offsets wrap to its start, as the reference's
    rolls do."""
    d = data.to(torch.int64)
    return to_i32(d | (torch.roll(d, -1, dims=1) << 8)
                  | (torch.roll(d, -2, dims=1) << 16)
                  | (torch.roll(d, -3, dims=1) << 24))


def _match_bytes_u32(x: torch.Tensor) -> torch.Tensor:
    """Equal leading BYTES (0..4) of a little-endian u32 xor value given
    as an int32 bit pattern."""
    return (((x & 0xFF) == 0).to(torch.int32)
            + ((x & 0xFFFF) == 0).to(torch.int32)
            + ((x & 0xFFFFFF) == 0).to(torch.int32)
            + (x == 0).to(torch.int32))


def _span_len_col(span_len, NB: int, device) -> torch.Tensor:
    """span_len as a column: a scalar (one span) or [NB] (per-block span
    lengths, for multi-buffer batches)."""
    sl = torch.as_tensor(span_len, device=device)
    return sl.reshape(1, 1) if sl.dim() == 0 else sl[:, None]


def best_candidate_sorted(h, valid_insert, words, cap_at, k: int,
                          window: int):
    """Screen all K candidates of every position in sorted space.

    h [NB, M] int64 hashes, valid_insert [NB, M] bool, words and cap_at
    [NB, M] int32. Sorting the keys (h << 17) | idx (unique, int64 here
    where the reference has u32) makes each position's K most recent
    same-hash predecessors its K sorted-order neighbours; invalid
    positions get the key 0xFFFFFFFF and sort last. Returns best_j (the
    winner's M-index or -1) and best_screen (its clamped 8-byte match or
    -1), [NB, M] int32 in position order."""
    NB, M = h.shape
    dev = h.device
    idx = torch.arange(M, device=dev, dtype=torch.int64).expand(NB, M)
    key = torch.where(valid_insert, (h << 17) | idx, U32)
    skey, perm = torch.sort(key, dim=1, stable=True)
    spos = (skey & 0x1FFFF).to(torch.int32)
    shash = skey >> 17
    sval = skey != U32
    sw0 = words.gather(1, perm)
    sw4 = torch.roll(words, -4, dims=1).gather(1, perm)
    screen_cap = torch.clamp(cap_at.gather(1, perm), max=8)
    col = idx

    best_screen = torch.full((NB, M), -1, dtype=torch.int32, device=dev)
    best_j = torch.full((NB, M), -1, dtype=torch.int32, device=dev)
    for kk in range(1, k + 1):
        pp = torch.roll(spos, kk, dims=1)
        ok = ((col >= kk) & (torch.roll(shash, kk, dims=1) == shash)
              & torch.roll(sval, kk, dims=1) & sval & (spos - pp <= window))
        z0 = _match_bytes_u32(sw0 ^ torch.roll(sw0, kk, dims=1))
        z4 = _match_bytes_u32(sw4 ^ torch.roll(sw4, kk, dims=1))
        s = torch.minimum(torch.where(z0 == 4, 4 + z4, z0), screen_cap)
        s = torch.where(ok, s, -1)
        better = s > best_screen  # strict: ties keep the more recent
        best_screen = torch.where(better, s, best_screen)
        best_j = torch.where(better, pp, best_j)

    # Back to position order. Invalid entries (spos = 0x1FFFF, past every
    # row since M < 2^17) go to a spare column and are dropped.
    dest = torch.where(sval, spos.to(torch.int64), M)
    out_j = torch.full((NB, M + 1), -1, dtype=torch.int32, device=dev)
    out_s = torch.full((NB, M + 1), -1, dtype=torch.int32, device=dev)
    out_j.scatter_(1, dest, best_j)
    out_s.scatter_(1, dest, best_screen)
    return out_j[:, :M], out_s[:, :M]


def screen_candidates_w(words, span_off, span_len, k: int, window: int,
                        block: int, max_match: int):
    """The v1 screen over precomputed words [NB, M] int32: hash,
    per-position caps, sorted-space candidate screening. Returns (best_j,
    best_screen, words, cap_at), all [NB, M] int32 (block region at
    columns [window, window + block)).

    span_off [NB]: each block's offset in its buffer; span_len: scalar or
    [NB] (per-block buffer lengths: blocks of different buffers share one
    batch, and the insertable mask keeps their halos apart)."""
    NB, M = words.shape
    if M >= 1 << 17:
        raise ValueError(f"v1 screen: M = {M} must be below 2^17 (the "
                         "sort key holds the position in 17 bits)")
    dev = words.device
    slc = _span_len_col(span_len, NB, dev)
    idx = torch.arange(M, device=dev, dtype=torch.int32).expand(NB, M)
    gpos = span_off[:, None] + (idx - window)
    insertable = (gpos >= 0) & (gpos + MIN_MATCH <= slc)
    block_end_rel = torch.clamp(window + (slc - span_off[:, None]),
                                max=block + window)
    cap_at = torch.clamp(block_end_rel - idx, 0, max_match)
    cap_at = torch.where(idx >= window, cap_at, 0).to(torch.int32)
    bj, bs = best_candidate_sorted(hash3(words), insertable, words, cap_at,
                                   k, window)
    return bj, bs, words, cap_at


def screen_candidates(data, span_off, span_len, k: int, window: int,
                      block: int, max_match: int):
    """screen_candidates_w on the 4-byte windows of byte data [NB, M]."""
    return screen_candidates_w(words_at(data), span_off, span_len, k,
                               window, block, max_match)


# ------------------------------------------------------- rank extension

def build_ranks(words: torch.Tensor) -> dict:
    """Prefix-doubling ranks (the reference's build_ranks,
    tpz/kernels/matchfinder.py:336). words [NB, M] int32 bit patterns of u32
    4-byte windows. Returns {level: rank [NB, M] int32} for each level of
    RANK_LEVELS: positions compare by their next `level` bytes (the data
    past a row's end wraps, as the reference's rolls do; callers clamp
    lengths to real bounds). A rank is 1 + the number of distinct smaller
    keys.

    The reference sorts on (k1, k2, idx); torch has no multi-key sort
    (H4), so each level packs its keys into one int64 with the position
    last: the u32 word then 17 bits of position at level 4, and the rank,
    the rank `level / 2` on, then the position, 17 bits each, above."""
    NB, M = words.shape
    if M >= 1 << 17:
        raise ValueError(f"build_ranks: M = {M} must be below 2^17 (each "
                         "key holds a position and ranks in 17 bits)")
    idx = torch.arange(M, device=words.device, dtype=torch.int64)

    def assign_ranks(key):
        skey, sidx = torch.sort(key, dim=1)
        k = skey >> 17
        diff = torch.ones((NB, M), dtype=torch.int32, device=words.device)
        diff[:, 1:] = (k[:, 1:] != k[:, :-1]).to(torch.int32)
        return torch.empty_like(diff).scatter_(
            1, sidx, torch.cumsum(diff, dim=1, dtype=torch.int32))

    r = assign_ranks((as_u32(words) << 17) | idx)
    ranks = {4: r}
    for lvl in RANK_LEVELS[1:]:
        # Past the row's end the shift wraps; wrapped values only reach
        # the last `lvl / 2` columns, in the forward pad.
        shifted = torch.roll(r, -(lvl // 2), dims=1)
        r = assign_ranks((r.to(torch.int64) << 34)
                         | (shifted.to(torch.int64) << 17) | idx)
        ranks[lvl] = r
    return ranks


def lcp_from_ranks(ranks: dict, p: torch.Tensor, q: torch.Tensor,
                   words: torch.Tensor, data: torch.Tensor,
                   cap: torch.Tensor) -> torch.Tensor:
    """The common prefix length of the suffixes at M-indices p and q
    ([NB, B] int32), clamped to cap (the reference's lcp_from_ranks,
    tpz/kernels/matchfinder.py:370): down the rank levels 256..4, then
    the last bytes (fewer than 4) one by one from data [NB, M]."""
    maxi = words.shape[1] - 1
    ln = torch.zeros_like(p)
    cp, cq = p, q

    def at(t, i):
        return t.gather(1, torch.clamp(i, max=maxi).to(torch.int64))

    for lvl in reversed(RANK_LEVELS):
        take = (at(ranks[lvl], cp) == at(ranks[lvl], cq)) & (ln + lvl <= cap)
        ln = torch.where(take, ln + lvl, ln)
        cp = torch.where(take, cp + lvl, cp)
        cq = torch.where(take, cq + lvl, cq)
    for _ in range(3):
        take = (at(data, cp) == at(data, cq)) & (ln < cap)
        ln = torch.where(take, ln + 1, ln)
        cp = torch.where(take, cp + 1, cp)
        cq = torch.where(take, cq + 1, cq)
    return torch.minimum(ln, cap)


def find_matches(data: torch.Tensor, span_off: torch.Tensor, span_len,
                 k: int = 8, window: int = WINDOW, block: int = BLOCK,
                 max_match: int = MAX_MATCH):
    """Batched best match at every block position, spec v1 (the
    reference's find_matches, tpz/kernels/matchfinder.py:477).

    data [NB, M] int32 byte values: block b's bytes at [window, window +
    block), after its window halo and before the forward pad (zeros past
    the span). span_off [NB] int32: each block's offset in the span;
    span_len: the span's length (a scalar, or [NB]).

    Returns (match_len, match_dist) [NB, block] int32, 0 where no
    spec-valid match starts: the oracle's best match at each position,
    before any parse."""
    NB = data.shape[0]
    bj, bs, words, cap_at = screen_candidates(data, span_off, span_len, k,
                                              window, block, max_match)
    sl = slice(window, window + block)
    p = (torch.arange(block, device=data.device, dtype=torch.int32)
         + window).expand(NB, block)
    best_j, best_screen, cap = bj[:, sl], bs[:, sl], cap_at[:, sl]
    ranks = build_ranks(words)
    full = lcp_from_ranks(ranks, p, torch.clamp(best_j, min=0), words,
                          data.to(torch.int32), cap)
    need_ext = best_screen >= torch.clamp(cap, max=8)
    mlen = torch.where(need_ext, full, torch.clamp(best_screen, min=0))
    mdist = p - best_j
    valid = (best_j >= 0) & (best_screen >= MIN_MATCH) & (mlen >= MIN_MATCH)
    # The too-far rule of parse spec v1.
    valid = valid & ~((mlen == MIN_MATCH) & (mdist > TOO_FAR))
    return torch.where(valid, mlen, 0), torch.where(valid, mdist, 0)
