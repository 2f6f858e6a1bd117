"""Batched DEFLATE encode on one torch device (port of
tpz/kernels/deflate_pipeline.py, spec-v3 path).

Stages, all on the device except the block-type scan and the framing
(each the span tpz_torch.deflate.<name>; the names `stage_hook`
receives):
  words    haloed [NB, M] matrix of u32 little-endian 4-byte windows,
           after the host layout (span deflate.layout) and its copy to the
           device (span deflate.h2d)
  screen   sorted-space top-2 candidates (kernels/matchfinder.py; the
           neighbour scan a CUDA kernel on a card)
  parse    the spec-v3 walk (kernels/parse.py; CUDA kernel on a card)
  plan     symbol histograms + Huffman planning (deflate_plan_device.py)
  bitpack  prefix-sum bit packer (kernels/bitpack.py; one CUDA kernel on
           a card)
  fetch    device-to-host copy of the packed words, cut per buffer

Each buffer is its own DEFLATE stream (window reset between buffers);
all buffers' 64 KiB blocks share one batch. The bytes equal
cpp/deflate.cc's DeflateEncode with the same parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch import oracle
from tpz_torch.kernels import bitpack
from tpz_torch.kernels.deflate_plan_device import plan_device, plan_tables
from tpz_torch.kernels.matchfinder import (BLOCK, FWD_PAD, MAX_MATCH, TOO_FAR,
                                           WINDOW, suffix_screen)
from tpz_torch.kernels.parse import parse_extend_v3
from tpz_torch.utils.bits import to_i32
from tpz_torch.utils.profiling import _nohook, span, stage

# Largest batch one invocation encodes; bigger batches split into groups.
# A single buffer cannot split mid-stream (later blocks' bit offsets
# depend on earlier output), so one above this is encoded by the C++
# oracle, whose bytes equal this pipeline's by construction, as the
# reference does; each such buffer is counted in host_declines.
MAX_DEVICE_SPAN = 32 << 20
SCREEN_CHUNK = 64      # screen rows per sort, bounding its working set
PARSE_GROUP = 16       # blocks per plain-parse loop (CPU tensors only)
# Raw DEFLATE of b"": one fixed-Huffman block holding only end-of-block.
EMPTY_STREAM = b"\x03\x00"

# Buffers encoded on the host because they exceed MAX_DEVICE_SPAN.
host_declines = 0


def _host_encode(data: bytes, cfg, want_index: bool):
    """The oracle's stream for a buffer above MAX_DEVICE_SPAN; with
    want_index, (stream, None, None): it carries no block index."""
    global host_declines
    host_declines += 1
    with span("deflate.host_decline"):
        blob = oracle.deflate_encode(data, cfg.params_array())
    return (blob, None, None) if want_index else blob


def _make_words(span_u8: torch.Tensor) -> torch.Tensor:
    """span_u8: [WINDOW + nb*BLOCK + FWD_PAD] uint8 (leading WINDOW and
    trailing FWD_PAD zero padding) -> haloed [nb, M] int32 bit patterns of
    u32 little-endian 4-byte windows. The windows are built on the 1-D
    span, so they are exact across row boundaries. Needs
    WINDOW <= BLOCK and FWD_PAD <= BLOCK."""
    d = span_u8.to(torch.int64)
    w = to_i32(d | (torch.roll(d, -1) << 8) | (torch.roll(d, -2) << 16)
               | (torch.roll(d, -3) << 24))
    nb = (span_u8.shape[0] - WINDOW - FWD_PAD) // BLOCK
    base = w[WINDOW:WINDOW + nb * BLOCK].reshape(nb, BLOCK)
    prev_tail = torch.cat([w[:WINDOW][None, :], base[:-1, BLOCK - WINDOW:]])
    next_head = torch.cat([base[1:, :FWD_PAD],
                           torch.zeros((1, FWD_PAD), dtype=w.dtype,
                                       device=w.device)])
    return torch.cat([prev_tail, base, next_head], dim=1)


def _zero_past_end(words: torch.Tensor, block_len: torch.Tensor,
                   bfinal: torch.Tensor) -> torch.Tensor:
    """Zero the bytes past each buffer's end in the words of its last
    block's row, in place. In the batch's 1-D span the next buffer starts
    right after a buffer's last block, so a screen key near the end of a
    buffer that fills (or nearly fills) that block would read the next
    buffer's first bytes where the C++ oracle's keys read zeros, and the
    sorted neighbours, and so the bytes, could differ from the oracle's."""
    rows = torch.nonzero(bfinal).flatten()
    col = torch.arange(words.shape[1], device=words.device)
    rem = torch.clamp(WINDOW + block_len[rows, None].to(torch.int64) - col,
                      0, 4)
    mask = (torch.ones_like(rem) << (8 * rem)) - 1
    words[rows] = to_i32(words[rows].to(torch.int64) & mask)
    return words


def _hist(sym: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-row histogram [NB, nbins] int32 of sym [NB, B] in 0..nbins;
    the value nbins marks a masked position and is not counted."""
    NB = sym.shape[0]
    rows = torch.arange(NB, device=sym.device)[:, None] * (nbins + 1)
    h = torch.bincount((sym + rows).reshape(-1), minlength=NB * (nbins + 1))
    return h.reshape(NB, nbins + 1)[:, :nbins].to(torch.int32)


def _fused_encode(span, span_off, span_len, block_len, buf_start, bfinal,
                  cfg, stage_hook):
    """span and the [NB] vectors on the device -> (words [total_words]
    int32 on the device, end_pos [NB] numpy: each block's end bit)."""
    sb = cfg.screen_bytes
    with stage("deflate", "words", stage_hook):
        words = _zero_past_end(_make_words(span), block_len, bfinal)
    with stage("deflate", "screen", stage_hook):
        pk1, pk2, cap_at = suffix_screen(
            words, span_off, span_len, cfg.max_chain, WINDOW, BLOCK,
            MAX_MATCH, sb, cfg.restart, SCREEN_CHUNK)
    sl = slice(WINDOW, WINDOW + BLOCK)
    with stage("deflate", "parse", stage_hook):
        visited, mlen, mdist = parse_extend_v3(
            pk1[:, sl].contiguous(), pk2[:, sl].contiguous(),
            cap_at[:, sl].contiguous(), words, block_len, WINDOW, MAX_MATCH,
            sb, TOO_FAR, cfg.lazy, cfg.max_lazy, cfg.restart, cfg.n_extend,
            PARSE_GROUP)

    NB = words.shape[0]
    with stage("deflate", "plan", stage_hook):
        pos = torch.arange(BLOCK, device=words.device, dtype=torch.int32)
        is_token = (visited > 0) & (pos < block_len[:, None])
        data_block = words[:, sl] & 0xFF
        is_match = is_token & (mlen > 0)
        lsym, _, _ = bitpack.length_symbol(torch.clamp(mlen, 0, 258))
        dsym, _, _ = bitpack.dist_symbol(torch.clamp(mdist, min=1))
        lit_sym = torch.where(is_match, lsym, data_block)
        lit_hist = _hist(torch.where(is_token, torch.clamp(lit_sym, 0, 287),
                                     288), 288)
        dist_hist = _hist(torch.where(is_match, torch.clamp(dsym, 0, 29),
                                      30), 30)
        tables = {k: torch.from_numpy(v).to(words.device)
                  for k, v in plan_tables().items()}
        plan = plan_device(lit_hist, dist_hist, block_len, buf_start, bfinal,
                           tables, live=block_len > 0)
        end_pos = plan["end_pos"].cpu().numpy()

    with stage("deflate", "bitpack", stage_hook):
        table320 = torch.cat([plan["lit_cl"], plan["dist_cl"],
                              torch.zeros((NB, 2), dtype=torch.int32,
                                          device=words.device)], dim=1)
        total_words = (int(end_pos[-1]) + 31) // 32
        out = bitpack.pack_deflate(
            data_block, is_token, mlen, mdist, table320, plan["body_off"],
            plan["btype"], block_len, plan["chunk1_off"],
            (plan["hdr_vals"], plan["hdr_nbits"], plan["hdr_offs"]),
            total_words)
    return out, end_pos


def span_layout(datas):
    """Lay nonempty buffers out as one zero-padded span of 64 KiB blocks.

    Returns numpy (span uint8, span_off, span_len, block_len int32 [NB],
    buf_start, bfinal bool [NB], nbs: blocks per buffer). Each buffer's
    first block starts a word-aligned output region; its last block
    carries BFINAL."""
    nbs = [(len(d) + BLOCK - 1) // BLOCK for d in datas]
    NB = sum(nbs)
    span = np.zeros(WINDOW + NB * BLOCK + FWD_PAD, dtype=np.uint8)
    span_off = np.empty(NB, np.int32)
    span_len = np.empty(NB, np.int32)
    block_len = np.empty(NB, np.int32)
    buf_start = np.zeros(NB, bool)
    bfinal = np.zeros(NB, bool)
    b0 = 0
    for d, nb_i in zip(datas, nbs):
        pos = WINDOW + b0 * BLOCK
        span[pos:pos + len(d)] = np.frombuffer(memoryview(d), np.uint8)
        span_off[b0:b0 + nb_i] = np.arange(nb_i) * BLOCK
        span_len[b0:b0 + nb_i] = len(d)
        block_len[b0:b0 + nb_i] = np.minimum(
            len(d) - np.arange(nb_i) * BLOCK, BLOCK)
        buf_start[b0] = True
        bfinal[b0 + nb_i - 1] = True
        b0 += nb_i
    return span, span_off, span_len, block_len, buf_start, bfinal, nbs


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def compress(data: bytes, cfg, device) -> bytes:
    """Raw DEFLATE encode of one buffer."""
    return compress_many([data], cfg, device)[0]


def compress_indexed(data: bytes, cfg, device):
    """Encode one buffer; returns (stream, block_end_bits, block_out_lens),
    the block index the gzip 'TZ' side-car carries."""
    return compress_many([data], cfg, device, want_index=True)[0]


def compress_many(datas, cfg, device, want_index: bool = False,
                  stage_hook=_nohook):
    """Batch-encode independent buffers; one raw DEFLATE stream each.

    cfg: a tpz_torch.codecs.deflate.DeflateConfig. With want_index each
    result is (stream, block_end_bits int64 [nb], block_out_lens int64
    [nb]). stage_hook(name) is called after each device stage (for
    timing; see the module docstring for the names)."""
    device = _device(device)
    datas = list(datas)
    results = [None] * len(datas)
    idxs = [i for i, d in enumerate(datas) if len(d) > 0]
    for i, d in enumerate(datas):
        if len(d) == 0:
            results[i] = ((EMPTY_STREAM, np.array([8 * len(EMPTY_STREAM)]),
                           np.array([0])) if want_index else EMPTY_STREAM)
    if not idxs:
        return results

    if sum(len(datas[i]) for i in idxs) > MAX_DEVICE_SPAN:
        for i in list(idxs):
            if len(datas[i]) > MAX_DEVICE_SPAN:
                results[i] = _host_encode(datas[i], cfg, want_index)
                idxs.remove(i)
        group, group_bytes = [], 0
        for i in idxs + [None]:
            if group and (i is None
                          or group_bytes + len(datas[i]) > MAX_DEVICE_SPAN):
                for gi, res in zip(group, compress_many(
                        [datas[g] for g in group], cfg, device, want_index,
                        stage_hook)):
                    results[gi] = res
                group, group_bytes = [], 0
            if i is not None:
                group.append(i)
                group_bytes += len(datas[i])
        return results

    with span("deflate.words"):
        with span("deflate.layout"):
            layout = span_layout([datas[i] for i in idxs])
        with span("deflate.h2d"):
            args = [torch.from_numpy(a).to(device) for a in layout[:6]]
    out_words, end_pos = _fused_encode(*args, cfg, stage_hook)

    with stage("deflate", "fetch", stage_hook):
        body = out_words.cpu().numpy().view(np.uint8)
        block_len, nbs = layout[3], layout[6]
        b0 = 0
        start_bit = 0
        for i, nb_i in zip(idxs, nbs):
            end_bit = int(end_pos[b0 + nb_i - 1])
            blob = body[start_bit // 8:(end_bit + 7) // 8].tobytes()
            if want_index:
                ends = end_pos[b0:b0 + nb_i].astype(np.int64) - start_bit
                results[i] = (blob, ends,
                              block_len[b0:b0 + nb_i].astype(np.int64))
            else:
                results[i] = blob
            start_bit = (end_bit + 31) // 32 * 32
            b0 += nb_i
    return results
