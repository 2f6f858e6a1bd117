"""Batched LZHUF (LHA lh4-lh7) encode on one torch device (port of
tpz/kernels/lzhuf_pipeline.py, the route its TPU path takes).

Stages (each the span tpz_torch.lzhuf.<name>; the names `stage_hook`
receives):
  blocks   every buffer's 32 KiB blocks with a halo of 2^dict_bits bytes
           before them (more than one block for lh7) and FWD bytes after
  screen   the spec-v1 hash screen (kernels/matchfinder.py)
  parse    the spec-v1 parse walk (kernels/parse.py; CUDA kernel on a card)
  hist     per-block c and p symbol histograms and token counts
  plan     kernels/lzhuf_plan_device.py on the device, all of the group's
           blocks at once: code lengths, canonical codes, block header
           slots, bit offsets; one copy of the buffers' bit totals
  pack     c and p codes with the raw distance bits, and the header
           slots, MSB-first bitpack into one set of words
  fetch    device-to-host copy of the packed words
  merge    (host) each buffer's stream cut from its word-aligned region
Each buffer is its own stream, and all buffers' blocks share one batch.
The bytes equal cpp/lzhuf.cc's LzhufEncodeBytes with max_chain 16
(MAX_CHAIN, the reference codec's one profile).
"""

from __future__ import annotations

import numpy as np
import torch

from tpz_torch import constants as C
from tpz_torch.kernels import lzhuf_plan_device
from tpz_torch.kernels.bitpack import assemble_stream_msb
from tpz_torch.kernels.deflate_pipeline import _device, _hist
from tpz_torch.kernels.matchfinder import screen_candidates
from tpz_torch.kernels.parse import parse_extend_v1
from tpz_torch.utils.profiling import _nohook, stage

BLOCK = 32768
FWD = 512
MAX_MATCH = C.LZHUF_MAX_MATCH
NC = C.LZHUF_NC
MAX_CHAIN = 16
# Largest batch one invocation encodes; bigger batches split into groups
# of whole buffers (each buffer is its own stream).
MAX_DEVICE_SPAN = 32 << 20

# Groups planned on the device (one lzhuf_plan_device.plan call each).
device_plans = 0


def _bitlen16(p: torch.Tensor) -> torch.Tensor:
    """bit_length(p) for p in [0, 65536)."""
    c = torch.zeros_like(p)
    for k in range(17):
        c = c + (p >= (1 << k)).to(p.dtype)
    return c


def make_blocks(datas, window: int, device):
    """Nonempty buffers -> (blocks [NB, window + BLOCK + FWD] uint8 on the
    device, span_off, span_len, block_len [NB] int32 numpy, nbs: blocks
    per buffer). Block b of a buffer holds its bytes [b*BLOCK - window,
    (b+1)*BLOCK + FWD), zero outside the buffer."""
    M = window + BLOCK + FWD
    nbs = [(len(d) + BLOCK - 1) // BLOCK for d in datas]
    rows = []
    for d, nb in zip(datas, nbs):
        span = np.zeros(window + nb * BLOCK + FWD, np.uint8)
        span[window:window + len(d)] = np.frombuffer(memoryview(d), np.uint8)
        rows.append(torch.from_numpy(span).to(device).unfold(0, M, BLOCK))
    blocks = torch.cat(rows) if len(rows) > 1 else rows[0].contiguous()
    span_off = np.concatenate([np.arange(nb) * BLOCK for nb in nbs])
    span_len = np.concatenate([np.full(nb, len(d)) for d, nb in
                               zip(datas, nbs)])
    block_len = np.minimum(span_len - span_off, BLOCK)
    return (blocks, span_off.astype(np.int32), span_len.astype(np.int32),
            block_len.astype(np.int32), nbs)


def _stage1(blocks, span_off, span_len, block_len, k: int, window: int,
            np_: int, stage_hook=_nohook):
    """Screen, parse and histograms. blocks [NB, M] bytes; span_off,
    span_len, block_len [NB] int32 tensors. Returns (mlen, mdist, is_token
    [NB, BLOCK], c_hist [NB, NC], p_hist [NB, np_], ntokens [NB]) as the
    reference's _stage1 on its TPU route."""
    sl = slice(window, window + BLOCK)
    with stage("lzhuf", "screen", stage_hook):
        bj, bs, words, _ = screen_candidates(blocks, span_off, span_len, k,
                                             window, BLOCK, MAX_MATCH)
    with stage("lzhuf", "parse", stage_hook):
        bjb = bj[:, sl].contiguous()
        reach, mlen = parse_extend_v1(bs[:, sl].contiguous(), bjb, words,
                                      block_len, window, max_match=MAX_MATCH)
    with stage("lzhuf", "hist", stage_hook):
        pos = torch.arange(BLOCK, device=blocks.device, dtype=torch.int32)
        is_token = (reach > 0) & (pos < block_len[:, None])
        mdist = torch.where(mlen > 0, pos + window - bjb, 0)
        ntokens = is_token.sum(dim=1, dtype=torch.int32)
        is_match = is_token & (mlen > 0)
        csym = torch.where(is_match, 256 + mlen - 3,
                           blocks[:, sl].to(torch.int32))
        psym = _bitlen16(torch.clamp(mdist, min=1) - 1)
        c_hist = _hist(torch.where(is_token, torch.clamp(csym, 0, NC - 1),
                                   NC), NC)
        p_hist = _hist(torch.where(is_match, torch.clamp(psym, 0, np_ - 1),
                                   np_), np_)
    return mlen, mdist, is_token, c_hist, p_hist, ntokens


def _stage2(data_block, is_token, mlen, mdist, c_len, c_code, p_len, p_code,
            body_off, total_words: int):
    """Per-token slots (the c code; the p code with the distance's raw
    bits) packed MSB-first. data_block, mlen, mdist [NB, BLOCK] int32;
    is_token bool; c_len, c_code [NB, NC] and p_len, p_code [NB, 20]
    int32; body_off [NB] int64. Returns [total_words] int64 u32 words."""
    NB = data_block.shape[0]
    is_match = is_token & (mlen > 0)
    csym = torch.where(is_match, 256 + mlen - 3,
                       torch.where(is_token, data_block, 0)).to(torch.int64)
    cc = torch.gather(c_code, 1, csym).to(torch.int64)
    cn = torch.where(is_token, torch.gather(c_len, 1, csym), 0)
    p = (torch.clamp(mdist, min=1) - 1).to(torch.int64)
    c = _bitlen16(p)
    raw_bits = torch.clamp(c - 1, min=0)
    raw_val = p & ((1 << raw_bits) - 1)
    pi = torch.clamp(c, 0, 19)
    pc = torch.gather(p_code, 1, pi).to(torch.int64)
    pn = torch.gather(p_len, 1, pi)
    slot1_val = (pc << raw_bits) | raw_val
    slot1_n = torch.where(is_match, pn + raw_bits.to(torch.int32), 0)
    vals = torch.stack([cc, slot1_val], dim=2).reshape(NB, 2 * BLOCK)
    nbits = torch.stack([cn, slot1_n], dim=2).reshape(NB, 2 * BLOCK)
    return assemble_stream_msb(vals, nbits, body_off, total_words)


def compress(data: bytes, method: str = "lh5", device="cuda") -> bytes:
    return compress_many([data], method, device)[0]


def compress_many(datas, method: str = "lh5", device="cuda", *,
                  stage_hook=_nohook) -> list[bytes]:
    """Batch encode: every buffer's blocks share one device batch and one
    device plan, and each buffer's bits pack into a word-aligned region of
    one output. Returns raw LZHUF bodies (b"" for b"")."""
    device = _device(device)
    dict_bits, np_ = C.LZHUF_METHODS[method]
    window = 1 << dict_bits
    datas = list(datas)
    results = [None] * len(datas)
    idxs = [i for i, d in enumerate(datas) if len(d) > 0]
    for i, d in enumerate(datas):
        if len(d) == 0:
            results[i] = b""
    group, group_bytes = [], 0
    for i in idxs + [None]:
        if group and (i is None
                      or group_bytes + len(datas[i]) > MAX_DEVICE_SPAN):
            for gi, body in zip(group, _encode_group(
                    [datas[g] for g in group], np_, window, device,
                    stage_hook)):
                results[gi] = body
            group, group_bytes = [], 0
        if i is not None:
            group.append(i)
            group_bytes += len(datas[i])
    return results


def _encode_group(datas, np_, window, device, stage_hook) -> list[bytes]:
    global device_plans
    with stage("lzhuf", "blocks", stage_hook):
        blocks, span_off, span_len, block_len, nbs = make_blocks(
            datas, window, device)

    def dev(a):
        return torch.from_numpy(a).to(device)

    mlen, mdist, is_token, c_hist, p_hist, ntokens = _stage1(
        blocks, dev(span_off), dev(span_len), dev(block_len), MAX_CHAIN,
        window, np_, stage_hook)
    with stage("lzhuf", "plan", stage_hook):
        plan = lzhuf_plan_device.plan(c_hist, p_hist, ntokens, nbs, np_)
    device_plans += 1
    # The exact word count: regions are cut out by bit offset below (the
    # reference rounds it up only to bound XLA recompiles).
    total_words = max(1, -(-int(plan.region_bits[-1] + plan.total_bits[-1])
                           // 32))

    with stage("lzhuf", "pack", stage_hook):
        words = _stage2(blocks[:, window:window + BLOCK].to(torch.int32),
                        is_token, mlen, mdist, plan.c_len, plan.c_code,
                        plan.p_len, plan.p_code, plan.body_off, total_words)
        # Header and body bits are disjoint: add is or.
        words += assemble_stream_msb(plan.head_vals, plan.head_bits,
                                     plan.head_off, total_words)
    with stage("lzhuf", "fetch", stage_hook):
        body = words.cpu().numpy().astype(">u4").view(np.uint8)  # MSB first
    with stage("lzhuf", "merge", stage_hook):
        return [body[rb // 8:rb // 8 + (tb + 7) // 8].tobytes()
                for rb, tb in zip(plan.region_bits, plan.total_bits)]
