"""bzip2's RLE2 encode (port of tpz/kernels/rle.py `rle2_encode`).

A zero run of length m emits floor(log2(m + 1)) RUNA/RUNB symbols, digit
i being bit i of m + 1 (0 -> RUNA, 1 -> RUNB), the bijective base-2 code;
a rank v > 0 emits v + 1. Digit i of a run rides the run's i-th zero
position (a run of m zeros has at most m digits), so every position emits
at most one symbol, at its row's exclusive prefix count of emitters.

The reference places the stream with an inverse-permutation sort and
finds each zero's run start and end by cummax and reverse cummin, as the
TPU prices scatters per update. Here each run's start and end are one
scatter each (runs numbered by a prefix count of run starts) and the
stream is placed by one scatter. Prefix sums run over the flattened batch
(`row_cumsum`): a scan along a short batch of long rows runs far slower
than one scan of the same elements.

`rle1_encode` (the bzip2 pre-pass) is not on the port's path: the host
oracle runs RLE1 and the block split, as in the reference's pipeline.
"""

from __future__ import annotations

import torch


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the rows of x [NB, n] (int or bool), as
    int64, by one scan over the flattened batch minus each row's base."""
    NB, n = x.shape
    c = torch.cumsum(x.reshape(-1), 0, dtype=torch.int64).reshape(NB, n)
    return c - (c[:, :1] - x[:, :1].to(torch.int64))


def rle2_encode(r: torch.Tensor, length: torch.Tensor):
    """r [NB, n] int32 MTF ranks; length [NB] int32. Returns (syms
    [NB, n + 8] int32 RLE2 symbols, RUNA = 0, RUNB = 1 and v -> v + 1,
    zero past each row's count; sym_len [NB] int32). The end-of-block
    symbol is appended by the caller."""
    NB, n = r.shape
    dev = r.device
    idx = torch.arange(n, device=dev, dtype=torch.int32).expand(NB, n)
    live = idx < length[:, None]
    is_zero = live & (r == 0)
    no = torch.zeros((NB, 1), dtype=torch.bool, device=dev)
    zstart = is_zero & ~torch.cat([no, is_zero[:, :-1]], dim=1)
    zend = is_zero & ~torch.cat([is_zero[:, 1:], no], dim=1)
    # Run k (numbered over the whole batch from 1) starts at starts[k] and
    # ends at ends[k], flat positions; slot 0 takes the non-starts.
    flat = torch.arange(NB * n, device=dev, dtype=torch.int64)
    rid = torch.cumsum(zstart.reshape(-1), 0)
    starts = torch.zeros(NB * n + 1, dtype=torch.int64, device=dev)
    ends = torch.zeros_like(starts)
    starts.scatter_(0, torch.where(zstart.reshape(-1), rid, 0), flat)
    ends.scatter_(0, torch.where(zend.reshape(-1), rid, 0), flat)
    s0 = starts[rid]
    m = (ends[rid] - s0 + 1).reshape(NB, n)
    j = torch.clamp(flat - s0, 0, 30).reshape(NB, n)
    mp1 = m + 1
    nd = torch.zeros_like(m)      # bit_length(m + 1) - 1
    for k in range(1, 22):
        nd = nd + (mp1 >= (1 << k)).to(torch.int64)
    emit_digit = is_zero & (j < nd)
    emit_plain = live & ~is_zero
    emit = emit_plain | emit_digit
    val = torch.where(emit_plain, r + 1,
                      torch.where(emit_digit, ((mp1 >> j) & 1).to(torch.int32),
                                  0))
    offs = row_cumsum(emit)
    sym_len = offs[:, -1].to(torch.int32)
    out = torch.zeros((NB, n + 9), dtype=torch.int32, device=dev)
    out.scatter_(1, torch.where(emit, offs - 1, n + 8), val)
    return out[:, :n + 8], sym_len
