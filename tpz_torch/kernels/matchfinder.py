"""Spec-v3 suffix screening in torch (port of tpz/kernels/matchfinder.py
`suffix_screen_w` / `suffix_screen_w_chunked`).

Every insertable position is sorted by its `screen_bytes`-byte big-endian
prefix; each position then scans `r_neighbors` sorted neighbours in each
direction and keeps the top-2 candidates by (clamped screen, recency).
The outputs are bit-identical to the reference's.

Words arrive as int32 bit patterns of u32 little-endian 4-byte windows.
"""

from __future__ import annotations

import torch

from tpz_torch.utils.bits import as_u32, srl32

WINDOW = 32768
BLOCK = 65536
FWD_PAD = 512          # forward pad: max_match rounded up + screen slack
M_TOTAL = WINDOW + BLOCK + FWD_PAD
MAX_MATCH = 258
MIN_MATCH = 3
TOO_FAR = 4096

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
