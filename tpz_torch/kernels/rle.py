"""bzip2's RLE1 and RLE2 encodes (port of tpz/kernels/rle.py
`rle1_encode` and `rle2_encode`).

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

`rle1_encode` (the bzip2 pre-pass) is not on the port's encode path: the
host oracle runs RLE1 and the block split, as in the reference's
pipeline. It is the reference's segmented scan as torch ops: run starts
by neighbour compare and `torch.cummax`, run ends by a reverse
`torch.cummin`, and the emitted bytes placed by `scatter_reduce("amax")`
at a prefix count of emitters.
"""

from __future__ import annotations

import torch


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the rows of x [NB, n] (int or bool), as
    int64, by one scan over the flattened batch minus each row's base."""
    NB, n = x.shape
    c = torch.cumsum(x.reshape(-1), 0, dtype=torch.int64).reshape(NB, n)
    return c - (c[:, :1] - x[:, :1].to(torch.int64))


def _run_starts(x: torch.Tensor):
    """x [NB, n]. Returns (is_start [NB, n] bool, start_idx [NB, n] int64:
    the index of the first position of the maximal run holding each
    position)."""
    NB, n = x.shape
    is_start = torch.ones((NB, n), dtype=torch.bool, device=x.device)
    is_start[:, 1:] = x[:, 1:] != x[:, :-1]
    idx = torch.arange(n, device=x.device).expand(NB, n)
    start_idx = torch.cummax(torch.where(is_start, idx, -1), dim=1).values
    return is_start, start_idx


def rle1_encode(d: torch.Tensor, length: torch.Tensor):
    """The reference's rle1_encode (tpz/kernels/rle.py:40). d [NB, n]
    int32 bytes; length [NB]. Returns (out [NB, n + n // 4 + 8] int32
    RLE1 bytes, zero past each row's count; out_len [NB] int32).
    A maximal byte run is cut into units of at most 259 bytes; a unit of
    4 or more emits 4 bytes and a count byte (its length - 4), a shorter
    one its bytes, unit for unit as the C++ oracle's Rle1Units."""
    NB, n = d.shape
    dev = d.device
    idx = torch.arange(n, device=dev).expand(NB, n)
    live = idx < length[:, None]
    # Unique negative values past the length end every run there.
    dm = torch.where(live, d.to(torch.int64), -1 - idx)
    is_start, start_idx = _run_starts(dm)
    j = idx - start_idx                       # offset in the maximal run
    # The next run's start: a reverse cummin of the starts, shifted by one.
    starts = torch.where(is_start, idx, n)
    nxt = torch.flip(torch.cummin(torch.flip(starts, [1]), dim=1).values,
                     [1])
    next_start = torch.cat([nxt[:, 1:], torch.full((NB, 1), n, device=dev,
                                                   dtype=nxt.dtype)], dim=1)
    run_len = next_start - start_idx
    u_pos = j % 259
    u_len = torch.clamp(run_len - (j - u_pos), max=259)
    is_countpos = (u_pos == 3) & (u_len >= 4)
    emit = torch.where(live, (u_pos < 4).to(torch.int64)
                       + is_countpos.to(torch.int64), 0)
    offs = row_cumsum(emit) - emit
    out_len = (offs[:, -1] + emit[:, -1]).to(torch.int32)
    cap = n + n // 4 + 8
    out = torch.zeros((NB, cap + 1), dtype=torch.int32, device=dev)
    o0 = torch.where(live & (u_pos < 4), offs, cap)
    out.scatter_reduce_(1, o0, d.to(torch.int32), "amax")
    o1 = torch.where(live & is_countpos, offs + 1, cap)
    out.scatter_reduce_(1, o1, torch.clamp(u_len - 4, 0, 255).to(torch.int32),
                        "amax")
    return out[:, :cap], out_len


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
