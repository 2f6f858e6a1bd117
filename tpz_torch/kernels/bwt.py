"""Burrows-Wheeler transform of bzip2 blocks (port of tpz/kernels/bwt.py).

Cyclic prefix doubling over width-N rows: rotations are ranked by their
first 4 bytes (the cyclic words), then round after round by the rank pair
(rank[i], rank[(i + k) mod n]) with k = 4, 8, 16, ..., until every live
rank of every row is distinct or k has reached N (the most rounds a row
can need); rotations still tied then are identical (periodic blocks) and
break by index, as
cpp/bzip2.cc BwtEncode breaks them. So (last column, orig pointer) equal
the oracle's.

The reference avoids scatters and gathers (the TPU prices them per
update): it shifts ranks and writes them back by sorts. Here the cyclic
shift is a gather, the rank write-back a scatter, and the reference's
3-key sort is one stable sort of the int64 key (row << 42) | (k1 << 21)
| k2 over the flattened batch, so every row sorts inside its own span and
ranks and INF (2^21 - 1) fit in 21 bits: N <= 2^20, which a bzip2 block
(at most 900,000 bytes after RLE1) meets.

Memory at N = 2^20: a few int64 [NB, N] arrays (8 MiB a block each) live
through a round, and the sort's keys and values twice that.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch.kernels.rle import row_cumsum

RANK_BITS = 21
INF = (1 << RANK_BITS) - 1
MAX_N = 1 << 20


def cyclic_words(blocks: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The reference's host form: [NB, N] uint8 + lengths -> [NB, N]
    uint32 big-endian cyclic words (w[i] = s[i .. i+3 mod n]); pad cells
    zero. The pipeline builds them on the device (cyclic_words_device);
    this copy holds that one equal to the reference in the tests."""
    NB, N = blocks.shape
    ext = np.concatenate([blocks, blocks[:, :3]], axis=1)
    w = np.zeros((NB, N), np.uint32)
    for s in (0, 1, 2, 3):
        w <<= 8
        w |= ext[:, s:N + s]
    for r in range(NB):
        n = int(lengths[r])
        lo = max(0, n - 3) if n >= 4 else 0
        row = blocks[r]
        for p in range(lo, n):
            w[r, p] = ((int(row[p]) << 24)
                       | (int(row[(p + 1) % n]) << 16)
                       | (int(row[(p + 2) % n]) << 8)
                       | int(row[(p + 3) % n]))
    pad = np.arange(N)[None, :] >= np.asarray(lengths)[:, None]
    w[pad] = 0
    return w


def _cyc_index(n: torch.Tensor, N: int, k) -> torch.Tensor:
    """[NB, N] int64 column index (i + k) mod n of each row (k an int or
    an [NB] tensor); 0 where n is 0."""
    i = torch.arange(N, device=n.device, dtype=torch.int64)[None, :]
    nn = torch.clamp(n.to(torch.int64), min=1)[:, None]
    kk = k[:, None] if isinstance(k, torch.Tensor) else k
    return (i + kk) % nn


def cyclic_words_device(rows_u8: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """rows_u8 [NB, N] uint8 blocks, lengths [NB] -> [NB, N] int64 holding
    the u32 cyclic words of `cyclic_words`, built where the rows lie: a
    gather of bytes (i + k) mod n for k = 0..3. Pad cells are 0."""
    NB, N = rows_u8.shape
    d = rows_u8.to(torch.int64)
    w = torch.zeros((NB, N), dtype=torch.int64, device=rows_u8.device)
    for k in range(4):
        w = (w << 8) | torch.gather(d, 1, _cyc_index(lengths, N, k))
    live = torch.arange(N, device=rows_u8.device)[None, :] < lengths[:, None]
    return torch.where(live, w, 0)


def _row_sort(key: torch.Tensor):
    """key [NB, N] int64 below 2^42 -> (sorted keys, permutation), both
    [NB * N] over flat positions: one stable sort of the flattened batch
    with the row in the high bits, so each row sorts inside its span."""
    NB, N = key.shape
    rows = torch.arange(NB, device=key.device, dtype=torch.int64)[:, None]
    return torch.sort((key | (rows << 42)).reshape(-1), stable=True)


def _ranks(key: torch.Tensor) -> torch.Tensor:
    """key [NB, N] int64 below 2^42 -> [NB, N] int64 ranks in position
    order: 1 + the number of distinct smaller keys in the row."""
    NB, N = key.shape
    sk, perm = _row_sort(key)
    diff = torch.ones_like(sk, dtype=torch.bool)
    diff[1:] = sk[1:] != sk[:-1]
    r = torch.empty(NB * N, dtype=torch.int64, device=key.device)
    r.scatter_(0, perm, row_cumsum(diff.reshape(NB, N)).reshape(-1))
    return r.reshape(NB, N)


def bwt_batched(w: torch.Tensor, n: torch.Tensor):
    """w [NB, N] int64 cyclic words (cyclic_words_device), n [NB] real
    lengths (1 <= n <= N <= 2^20). Returns (last [NB, N] int64, the BWT
    last column, INF past n; orig [NB] int64 origin pointers). The rounds
    this call ran are left in bwt_batched.rounds."""
    NB, N = w.shape
    rounds = max(1, (N - 1).bit_length())
    if N > MAX_N:
        raise ValueError(f"bwt: N = {N} above {MAX_N}: ranks would not fit")
    dev = w.device
    n64 = n.to(torch.int64)
    live = torch.arange(N, device=dev)[None, :] < n64[:, None]
    # Depth-4 ranks from the words; pads rank above every word.
    r = _ranks(torch.where(live, w, 1 << 32))

    k, i = 4, 0
    while i < rounds:
        # All live ranks distinct <=> each row's largest live rank is n.
        if bool((torch.where(live, r, 0).amax(dim=1) >= n64).all()):
            break
        shifted = torch.where(live, torch.gather(r, 1, _cyc_index(n, N, k)),
                              INF)
        r = _ranks((torch.where(live, r, INF) << RANK_BITS) | shifted)
        k, i = k * 2, i + 1
    bwt_batched.rounds = i

    # Rotations in (rank, index) order: the stable sort's tie-break. Row
    # rotation t contributes s[(t - 1) mod n] to the last column.
    _, perm = _row_sort(torch.where(live, r, INF))
    sa = (perm.reshape(NB, N) - torch.arange(NB, device=dev)[:, None] * N)
    d = w >> 24
    prev = torch.where(live, torch.gather(d, 1, _cyc_index(n, N, n64 - 1)),
                       INF)
    last = torch.gather(prev, 1, sa)
    orig = torch.argmax((sa == 0).to(torch.int32), dim=1)
    return last, orig


bwt_batched.rounds = 0
