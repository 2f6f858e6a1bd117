"""bzip2's back half on the device (port of
tpz/kernels/bzip2_plan_device.py): the multi-table Huffman coder and the
emission slots of every block, which the pipeline packs MSB first.

It mirrors cpp/bzip2.cc EncodeBlockFromMtf decision for decision, so the
bits equal the host coder's:
  - the table count by n_mtf thresholds,
  - the initial table partition by cumulative frequency, with its
    take-at-least-one-symbol quirk,
  - four greedy refinement rounds: each 50-symbol group takes the table
    of least cost (the first minimum on a tie, as the C++ `<`), then each
    table's frequencies + 1 go through package-merge to 17 bits
    (deflate_plan_device.package_merge_lengths, pad 1 << 30 for bzip2's
    frequency sums below 2^20) and canonical codes,
  - the selectors move-to-front coded (mtf.mtf_ranks at alpha 6) and
    unary, the lengths delta coded, the symbols MSB first.

Memory at the headline (36 blocks of N = 2^20): the group histograms
[NB * ~21,000, 258] int32 (~780 MB) and their float32 copy, and ~38.7 M
slots of int64 values and int32 widths.
"""

from __future__ import annotations

import torch

from tpz_torch.kernels.deflate_plan_device import (canonical_codes,
                                                   package_merge_lengths)
from tpz_torch.kernels.mtf import mtf_ranks

A = 258          # padded alphabet (n_used + 2 <= 258)
T = 6            # max tables
GROUP = 50
LIMIT = 17       # encoder code-length limit (cpp kCodeLenLimit)
PM_PAD = 1 << 30
N_ITERS = 4      # cpp kNIters


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x [NB, K] at column i [NB] -> [NB]."""
    return torch.gather(x, 1, i.to(torch.int64)[:, None])[:, 0]


def encode_blocks(syms, sym_len, used, n_used, orig, block_crc):
    """syms [NB, S] int32 RLE2 symbols (end-of-block not included),
    sym_len, n_used, orig [NB] int32, used [NB, 256] 0/1 int32, block_crc
    [NB] (u32 values). Returns (vals [NB, SL] int64 u32 values, nbits
    [NB, SL] int32, total_bits [NB] int64): each block's whole bit stream
    (block magic through symbols) as slots in stream order, for
    bitpack.assemble_stream_msb."""
    NB, S = syms.shape
    dev = syms.device
    i32 = torch.int32
    idx = torch.arange(S + 1, device=dev, dtype=i32).expand(NB, S + 1)
    eob = n_used + 1
    n_mtf = sym_len + 1
    alpha = n_used + 2
    # The symbol stream with end-of-block at column sym_len.
    symf = torch.nn.functional.pad(syms, (0, 1))
    symf = torch.where(idx == sym_len[:, None], eob[:, None], symf)
    live_sym = idx <= sym_len[:, None]
    symc = torch.clamp(torch.where(live_sym, symf, 0), 0, A - 1)

    # ---- group histograms (one scatter) + per-block frequencies ----
    G = (S + 1 + GROUP - 1) // GROUP
    gid = idx // GROUP
    bidx = torch.arange(NB, device=dev, dtype=torch.int64)[:, None]
    cell = torch.where(live_sym, (bidx * G + gid) * A + symc, NB * G * A)
    ghist = torch.zeros(NB * G * A + 1, dtype=i32, device=dev)
    ghist.index_add_(0, cell.reshape(-1),
                     torch.ones(1, dtype=i32, device=dev).expand(cell.numel()))
    ghist = ghist[:-1].reshape(NB, G, A)
    freq = ghist.sum(dim=1, dtype=i32)                    # [NB, A]

    # ---- table count thresholds (cpp EncodeBlockFromMtf) ----
    nt = (2 + (n_mtf >= 200).to(i32) + (n_mtf >= 600).to(i32)
          + (n_mtf >= 1200).to(i32) + (n_mtf >= 2400).to(i32))
    n_sel = (n_mtf + GROUP - 1) // GROUP

    # ---- initial partition by cumulative frequency ----
    # P[h] = sum freq[:h], h in 0..A (exclusive prefix).
    P = torch.nn.functional.pad(torch.cumsum(freq, dim=1, dtype=i32), (1, 0))
    h = torch.arange(A + 1, device=dev, dtype=i32)[None, :]
    sidx = torch.arange(A, device=dev, dtype=i32)[None, :]
    lens = torch.full((NB, T, A), 15, dtype=i32, device=dev)
    total = n_mtf
    acc_lo = torch.zeros(NB, dtype=i32, device=dev)
    for t_rev in range(T):
        t = nt - 1 - t_rev
        act = t_rev < nt
        target = total // torch.clamp(t + 1, min=1)
        pacc = _take(P, acc_lo)
        cond = (h > acc_lo[:, None]) & (
            ((P - pacc[:, None]) >= target[:, None]) | (h >= alpha[:, None]))
        # argmax of a bool row: its first True (0 when there is none).
        hi = torch.minimum(torch.argmax(cond.to(i32), dim=1).to(i32), alpha)
        # alpha == A with every symbol taken: no h in [0, A] satisfies
        # cond; the remaining tables get empty ranges, as the C++ loop's
        # hi == alpha.
        hi = torch.where(acc_lo >= alpha, acc_lo, hi)
        in_rng = (sidx >= acc_lo[:, None]) & (sidx < hi[:, None])
        lens[:, t_rev, :] = torch.where(
            act[:, None], torch.where(in_rng, 2, 15), lens[:, t_rev, :])
        taken = _take(P, hi) - pacc
        total = torch.where(act, total - taken, total)
        acc_lo = torch.where(act, hi, acc_lo)

    # ---- greedy refinement ----
    # The reference's two bf16 einsums are float32 batched products here:
    # their operands are integers (counts <= 50, lengths <= 17, 0/1 table
    # picks) and every sum an integer below 2^24 (a group's cost <= 850, a
    # table's count <= ~900 k), so float32 holds them exactly, and so does
    # TF32 (10-bit mantissa) for the operands, with float32 sums.
    gcol = torch.arange(G, device=dev, dtype=i32)[None, :]
    g_live = gcol < n_sel[:, None]
    tcol = torch.arange(T, device=dev, dtype=i32)[None, :]
    t_act = tcol < nt[:, None]                            # [NB, T]
    scol = torch.arange(A, device=dev, dtype=i32)[None, None, :]
    ghist_f = ghist.to(torch.float32)
    del ghist
    sel = torch.zeros((NB, G), dtype=torch.int64, device=dev)
    for _ in range(N_ITERS):
        cost = torch.bmm(ghist_f, lens.to(torch.float32).transpose(1, 2))
        cost = torch.where(t_act[:, None, :], cost, torch.inf)
        sel = torch.argmin(cost, dim=2)                   # first min wins
        onehot = ((sel[:, :, None] == tcol[:, None, :].to(torch.int64))
                  & g_live[:, :, None]).to(torch.float32)
        tfreq = torch.bmm(onehot.transpose(1, 2), ghist_f).to(i32)
        f = tfreq + (scol < alpha[:, None, None]).to(i32)
        lens = package_merge_lengths(f.reshape(NB * T, A), LIMIT,
                                     pad=PM_PAD).reshape(NB, T, A)
    del ghist_f
    codes = canonical_codes(lens.reshape(NB * T, A), LIMIT).reshape(NB, T, A)

    # ---- emission slots, per block in stream order ----
    one = torch.ones(NB, dtype=i32, device=dev)
    crc = block_crc.to(torch.int64)
    # header: magic (24 + 24), crc (16 + 16), randomized (1), orig (24),
    # used16 (16), used rows (16 x 16 or 0), ntables (3), nsel (15)
    used16_rows = used.reshape(NB, 16, 16)
    row_used = used16_rows.amax(dim=2) > 0                # [NB, 16]
    w16 = torch.arange(16, device=dev, dtype=i32)
    used16 = (row_used.to(i32) << (15 - w16)).sum(dim=1, dtype=i32)
    row_bits = ((used16_rows > 0).to(i32) << (15 - w16)).sum(dim=2,
                                                               dtype=i32)
    hdr = [(torch.full((NB,), 0x314159, dtype=torch.int64, device=dev),
            24 * one),
           (torch.full((NB,), 0x265359, dtype=torch.int64, device=dev),
            24 * one),
           (crc >> 16, 16 * one), (crc & 0xFFFF, 16 * one),
           (torch.zeros(NB, dtype=torch.int64, device=dev), one),
           (orig.to(torch.int64), 24 * one), (used16.to(torch.int64), 16 * one)]
    for r in range(16):
        hdr.append((row_bits[:, r].to(torch.int64),
                    torch.where(row_used[:, r], 16, 0).to(i32)))
    hdr += [(nt.to(torch.int64), 3 * one), (n_sel.to(torch.int64), 15 * one)]
    hv = torch.stack([v for v, _ in hdr], dim=1)
    hn = torch.stack([n for _, n in hdr], dim=1)

    # selectors: move-to-front over table ids, unary (j ones, then a 0).
    selj = mtf_ranks(sel.to(i32).contiguous(), n_sel.contiguous(), alpha=T)
    sel_val = ((1 << selj.to(torch.int64)) - 1) << 1
    sel_nb = torch.where(g_live, selj + 1, 0)

    # tables: per table a 5-bit start, then per symbol 2|delta| bits of
    # steps and a stop bit.
    prev = torch.cat([lens[:, :, :1], lens[:, :, :-1]], dim=2)
    delta = lens - prev                                   # [NB, T, A]
    k = delta.abs().to(torch.int64)
    t_live = t_act[:, :, None] & (scol < alpha[:, None, None])
    step_mask = torch.where(k >= 16, 0xFFFFFFFF, (1 << (2 * k)) - 1)
    step_val = torch.where(delta > 0, 0xAAAAAAAA & step_mask, step_mask)
    step_nb = torch.where(t_live, 2 * k.to(i32), 0)
    stop_nb = t_live.to(i32)
    start_val = lens[:, :, 0].to(torch.int64)
    start_nb = torch.where(t_act, 5, 0).to(i32)
    # interleaved per table: [start][s0 steps][s0 stop][s1 steps][s1 stop]..
    tab_vals = torch.cat(
        [start_val[:, :, None], torch.stack(
            [step_val, torch.zeros_like(step_val)], dim=3).reshape(NB, T, 2 * A)],
        dim=2).reshape(NB, T * (2 * A + 1))
    tab_nbs = torch.cat(
        [start_nb[:, :, None], torch.stack(
            [step_nb, stop_nb], dim=3).reshape(NB, T, 2 * A)],
        dim=2).reshape(NB, T * (2 * A + 1))

    # symbols: (code | len << 20) at (the group's table, symbol).
    packed = (codes | (lens << 20)).reshape(NB, T * A)
    sel_rep = torch.repeat_interleave(sel, GROUP, dim=1)[:, :S + 1]
    pe = torch.gather(packed, 1, torch.clamp(sel_rep, 0, T - 1) * A + symc)
    sym_vals = (pe & 0xFFFFF).to(torch.int64)
    sym_nbs = torch.where(live_sym, pe >> 20, 0)

    vals = torch.cat([hv, sel_val, tab_vals, sym_vals], dim=1)
    nbits = torch.cat([hn, sel_nb, tab_nbs, sym_nbs], dim=1)
    return vals, nbits, nbits.sum(dim=1, dtype=torch.int64)

