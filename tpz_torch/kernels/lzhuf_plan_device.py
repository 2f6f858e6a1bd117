"""LZHUF block planning on the device in torch: what cpp/lzhuf.cc's
LzhufPlan computes block by block (BuildTables, then EmitHeader), as
batched ops over all of a group's blocks, with no host loop over blocks
or buffers.

  - The C and P tables go through one package-merge to 16 bits
    (deflate_plan_device.package_merge_lengths, as [2 NB, 510] rows) and
    one canonical-code call; a table with at most one used symbol gets
    no lengths, as BuildTables gives it.
  - The T table (lengths of the C lengths) is the histogram of the C
    lengths' run-length form up to the last nonzero length. A zero run r
    is r times symbol 0 (r <= 2), symbol 1 with 4 extra bits (3..18),
    symbols 0 and 1 (19), or symbol 2 with 9 extra bits (20..510).
  - Each block's header is a row of MSB-first slots of at most 31 bits at
    fixed places (width 0 marks a dead slot), in stream order:
      the token count (16 bits);
      the T count: 5 bits, or 10 (a zero and the one symbol) when the T
        or the C table has at most one symbol;
      T entries 0..2, the 2-bit zero skip, T entries 3..18;
      the C count: 9 bits, or 18 (a zero and the one symbol);
      two slots a C position: a length's T code, or at a zero run's
        first position the run's T codes and extra bits (the run's other
        positions are dead);
      the P count: pbit bits, or 2 pbit; P entries 0..np-1.
    A T or P entry is 3 bits, or 3 ones, len - 7 ones and a zero.
  - A block's body bits are sum(c_hist * c_len) + sum(p_hist * (p_len +
    raw distance bits)); a segmented cumsum places each block's header
    and body in its buffer's stream, and each buffer's stream starts at a
    word-aligned region of the group's output.
lzhuf_pipeline.pack_words packs the header slots with the body.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpz_torch import constants as C
from tpz_torch.kernels.deflate_pipeline import _hist
from tpz_torch.kernels.deflate_plan_device import (canonical_codes,
                                                   package_merge_lengths)

NC = C.LZHUF_NC                  # 510
NT = C.LZHUF_NT                  # 19
P_COLS = 20                      # p tables are [NB, 20], as the oracle's
MAX_LEN = C.LZHUF_MAX_CODE_LEN   # 16, the C, P and T tables' limit
TBIT = C.LZHUF_TBIT
CBIT = C.LZHUF_CBIT


class Plan(NamedTuple):
    """c_len, c_code [NB, 510], p_len, p_code [NB, 20] int32; head_vals
    [NB, S] int64 and head_bits [NB, S] int32, the header slots; head_off,
    body_off [NB] int64 absolute bit offsets (all on the device);
    total_bits, region_bits [buffers] int64 numpy: each buffer's stream
    length and its region's first bit."""
    c_len: torch.Tensor
    c_code: torch.Tensor
    p_len: torch.Tensor
    p_code: torch.Tensor
    head_vals: torch.Tensor
    head_bits: torch.Tensor
    head_off: torch.Tensor
    body_off: torch.Tensor
    total_bits: np.ndarray
    region_bits: np.ndarray


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device, dtype=torch.int32)


def _count(x: torch.Tensor) -> torch.Tensor:
    """[NB, S] -> [NB]: the last nonzero column + 1 (0 for none)."""
    return torch.where(x > 0, _iota(x.shape[1], x) + 1, 0).amax(dim=1)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x [NB, K] at columns i [NB, S] -> [NB, S]."""
    return torch.gather(x, 1, i.to(torch.int64))


def _len_entries(lens: torch.Tensor, n: torch.Tensor):
    """WriteTLensT's and WritePLensT's entries: (vals int64, widths int32)
    [NB, S], live in the columns below n [NB]."""
    long = lens > 6
    vals = torch.where(long, ((1 << torch.clamp(lens - 4, min=0)) - 1) << 1,
                       lens)
    widths = torch.where(long, lens - 3, 3)
    live = _iota(lens.shape[1], lens) < n[:, None]
    return vals.to(torch.int64), torch.where(live, widths, 0)


def _c_runs(c_len: torch.Tensor):
    """The C lengths' run-length form (WriteCLensT) as two slots a
    position. Returns (sym, xbits, xval) for slot A and for slot B, each
    [NB, 510] int32: the T symbol (NT where the slot is dead) and the
    extra bits' width and value."""
    NB = c_len.shape[0]
    i = _iota(NC, c_len)
    valid = i < _count(c_len)[:, None]
    nz = c_len > 0
    prev_nz = torch.cat([torch.ones((NB, 1), dtype=torch.bool,
                                    device=c_len.device), nz[:, :-1]], dim=1)
    start = valid & ~nz & prev_nz
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(nz, i, NC), [1]),
                                  dim=1).values, [1])
    r = nxt - i
    short, mid, r19 = r <= 2, (r >= 3) & (r <= 18), r == 19
    sym_a = torch.where(nz, c_len + 2,
                        torch.where(short | r19, 0, torch.where(mid, 1, 2)))
    sym_a = torch.where(valid & (nz | start), sym_a, NT)
    xb_a = torch.where(start & ~short & ~r19, torch.where(mid, 4, 9), 0)
    xv_a = torch.where(xb_a > 0, torch.where(mid, r - 3, r - 20), 0)
    b_live = start & ((r == 2) | r19)
    sym_b = torch.where(b_live, torch.where(r19, 1, 0), NT)
    xb_b = torch.where(b_live & r19, 4, 0)
    xv_b = torch.where(b_live & r19, 15, 0)
    return (sym_a, xb_a, xv_a), (sym_b, xb_b, xv_b)


def _t_slots(t_len, t_code, sym, xbits, xval):
    """One C-position slot: the T code of sym, then the extra bits."""
    s = torch.clamp(sym, max=NT - 1)
    code = _take(t_code, s).to(torch.int64)
    width = torch.where(sym < NT, _take(t_len, s) + xbits, 0)
    return (code << xbits) | xval, width


def plan(c_hist: torch.Tensor, p_hist: torch.Tensor, ntokens: torch.Tensor,
         nbs, np_: int) -> Plan:
    """c_hist [NB, 510], p_hist [NB, np_], ntokens [NB] int32 on the
    device; nbs the blocks of each buffer, in order. One small
    device-to-host copy (the buffers' total bits)."""
    NB = c_hist.shape[0]
    dev = c_hist.device
    i64 = torch.int64

    # C and P code lengths and codes, one batch.
    hist = torch.cat([c_hist, torch.nn.functional.pad(p_hist,
                                                      (0, NC - np_))])
    used = (hist > 0).sum(dim=1, dtype=torch.int32)
    lens = torch.where((used > 1)[:, None],
                       package_merge_lengths(hist, MAX_LEN), 0)
    codes = canonical_codes(lens, MAX_LEN)
    c_len, c_code = lens[:NB], codes[:NB]
    p_len, p_code = lens[NB:, :P_COLS], codes[NB:, :P_COLS]
    cused, pused = used[:NB], used[NB:]

    # The T table.
    slot_a, slot_b = _c_runs(c_len)
    t_hist = _hist(torch.cat([slot_a[0], slot_b[0]], dim=1), NT)
    tused = (t_hist > 0).sum(dim=1, dtype=torch.int32)
    full_t = (cused > 1) & (tused > 1)
    t_len = torch.where(full_t[:, None], package_merge_lengths(t_hist,
                                                               MAX_LEN), 0)
    t_code = canonical_codes(t_len, MAX_LEN)

    # Header slots.
    n_t = _count(t_len)
    t_vals, t_bits = _len_entries(t_len, n_t)
    j = _iota(NT, t_len)
    zeros = (t_len[:, 3:6] == 0) & (j[3:6] < n_t[:, None])
    skip = torch.cumprod(zeros.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)
    skipped = (j >= 3) & (j < 3 + skip[:, None])
    t_bits = torch.where(full_t[:, None] & ~skipped, t_bits, 0)
    skip_bits = torch.where(full_t & (n_t >= 3), 2, 0)
    t_count = torch.where(full_t, n_t, torch.where(cused > 1,
                                                   _count(t_hist) - 1, 0))
    t_count_bits = torch.where(full_t, TBIT, 2 * TBIT)
    c_count = torch.where(cused > 1, _count(c_len),
                          torch.clamp(_count(c_hist) - 1, min=0))
    c_count_bits = torch.where(cused > 1, CBIT, 2 * CBIT)
    va, wa = _t_slots(t_len, t_code, *slot_a)
    vb, wb = _t_slots(t_len, t_code, *slot_b)
    pbit = 4 if np_ <= 14 else 5   # the P count's width (LzhufMethodFor)
    n_p = _count(p_len)
    p_vals, p_bits = _len_entries(p_len[:, :np_], n_p)
    p_bits = torch.where((pused > 1)[:, None], p_bits, 0)
    p_count = torch.where(pused > 1, n_p,
                          torch.clamp(_count(p_hist) - 1, min=0))
    p_count_bits = torch.where(pused > 1, pbit, 2 * pbit)

    def col(x):
        return x.to(i64)[:, None]

    head_vals = torch.cat([
        col(ntokens), col(t_count), t_vals[:, :3], col(skip), t_vals[:, 3:],
        col(c_count), torch.stack([va, vb], dim=2).reshape(NB, 2 * NC),
        col(p_count), p_vals], dim=1)
    head_bits = torch.cat([
        torch.full((NB, 1), 16, dtype=i64, device=dev), col(t_count_bits),
        t_bits[:, :3], col(skip_bits), t_bits[:, 3:], col(c_count_bits),
        torch.stack([wa, wb], dim=2).reshape(NB, 2 * NC), col(p_count_bits),
        p_bits], dim=1).to(torch.int32)

    # Offsets: each buffer's blocks back to back from its region's start.
    raw = torch.clamp(_iota(np_, p_hist) - 1, min=0)
    head = head_bits.sum(dim=1, dtype=i64)
    body = ((c_hist.to(i64) * c_len).sum(dim=1)
            + (p_hist.to(i64) * (p_len[:, :np_] + raw)).sum(dim=1))
    blk = head + body
    buf_of = torch.from_numpy(np.repeat(np.arange(len(nbs)), nbs)).to(dev)
    total = torch.zeros(len(nbs), dtype=i64, device=dev).index_add_(
        0, buf_of, blk)
    padded = (total + 31) // 32 * 32
    # A block's offset in the group's blocks laid end to end, moved from
    # its buffer's start there to its region's start.
    shift = ((torch.cumsum(padded, dim=0) - padded)
             - (torch.cumsum(total, dim=0) - total))
    head_off = torch.cumsum(blk, dim=0) - blk + shift[buf_of]
    total_bits = total.cpu().numpy()
    padded_np = (total_bits + 31) // 32 * 32
    return Plan(c_len, c_code, p_len, p_code, head_vals, head_bits, head_off,
                head_off + head, total_bits,
                np.cumsum(padded_np) - padded_np)
