"""Batched bzip2 encode and decode on one torch device (port of
tpz/kernels/bzip2_pipeline.py).

ENCODE, stage by stage (each the span tpz_torch.bzip2.<name>, also in
bzip2_walk and ibwt_walk; the names `stage_hook` receives):
  rle1          (host) RLE1 and the block split with block CRCs (C++)
  words         the blocks copied to the device as bytes, and their
                cyclic 4-byte words built there (bwt.cyclic_words_device)
  bwt           the cyclic prefix-doubling BWT (bwt.bwt_batched)
  mtf           the used-byte map and MTF encode (CUDA kernel on a card)
  rle2          RLE2 (rle.rle2_encode)
  plan          the multi-table Huffman coder and its emission slots
                (bzip2_plan_device.encode_blocks; the selectors' MTF runs
                the same kernel)
  pack          the MSB bit packing of every block at its stream offset
  fetch         device-to-host copy of the packed words
  frame         (host) each buffer's 'BZh<level>' header and end-of-stream
                trailer with its combined CRC
The batch has one bit layout: each buffer's stream starts word-aligned
after a 32-bit gap for its header, its blocks follow bit after bit. Every
block of a batch shares one dispatch of at most MAX_DISPATCH_BLOCKS
blocks; a bigger batch (or buffer) runs in several, cut between any two
blocks. Each dispatch packs its blocks at their offsets in that layout,
and the host ORs the dispatches' words together: two dispatches share at
most the word where one ends and the next begins. An empty buffer is the
format's empty stream. The bytes equal oracle.bzip2_encode's.

DECODE, stage by stage:
  scan          (host) each stream's block headers (cpp Bzip2ScanHeaders):
                block magics, selectors, code lengths, initial MTF lists
  slices        (host) each block's symbol-bit slice, its decode tables
                (bzip2_walk.build_tables) and the walk's layout
  h2d           the layout copied to the device
  walk          the symbol walk + MTF^-1 + RLE2^-1 (CUDA kernel on a card)
  expand        the run expansion into BWT last columns
  sort          the LF-mapping sort
  ibwt          the inverse BWT walk (CUDA kernels on a card)
  fetch         device-to-host copy of the plaintext rows
  eos           (host) the bits after every block: a block magic, or the
                end-of-stream magic and the stream's combined CRC
  rle1-inverse  (host) RLE1^-1 and every block's CRC (C++)
Streams are grouped by the record bucket of their highest level, and a
group's blocks share one dispatch of at most MAX_DISPATCH_BLOCKS blocks.

The reference's declines stay declines: a scan that returns None (or
raises, or a stream too short to scan), a block slice wider than the
bucket allows, a walk error, an iBWT flag, an EOS or combined-CRC
mismatch, or a DataError from the RLE1 inverse sends the stream to the
host decoder (cpp Bzip2Decode), and each such stream is counted in
`host_declines`. `decompress` of one stream first tries the reference's
second route (host symbol decode, device iBWT), counted in
`host_symbol_decodes`. The iBWT here has no slot-stream cap, so it declines
only periodic blocks.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpz_torch import oracle
from tpz_torch.errors import CompressionError, DataError
from tpz_torch.kernels import bzip2_walk
from tpz_torch.kernels.bitpack import assemble_stream_msb
from tpz_torch.kernels.bwt import bwt_batched, cyclic_words_device
from tpz_torch.kernels.bzip2_plan_device import encode_blocks
from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.kernels.ibwt_walk import ibwt_blocks_fast
from tpz_torch.kernels.mtf import mtf_ranks
from tpz_torch.kernels.rle import rle2_encode
from tpz_torch.utils.profiling import _nohook, span, stage

# Blocks per device dispatch: at N = 2^20 a block holds about 30 MB of
# device memory through the decode's walk, expansion and sort, and about
# 150 MB at the encode's peak (the coder's group histograms and slots), so
# this bounds a dispatch near 2 and 10 GB whatever the batch (a buffer's
# blocks may span dispatches). It changes no result.
MAX_DISPATCH_BLOCKS = 64
SLICE_SLACK = 8192        # bytes a block's slice may run past its bucket
EOS_MAGIC = 0x177245385090
BLOCK_MAGIC = 0x314159265359

# Streams handed to the host decoder because the device path declined
# their shape (see the module docstring).
host_declines = 0
# Streams decode() sent to its second route after the device walk declined
# them: the host decodes their symbols (cpp Bzip2ScanToLast) and only the
# iBWT runs on the device.
host_symbol_decodes = 0


def _host_decode(data: bytes) -> bytes:
    global host_declines
    host_declines += 1
    with span("bzip2.host_decline"):
        return oracle.bzip2_decode(data)


def _bucket(n: int) -> int:
    return 1 << max(13, (n - 1).bit_length())


def _max_level(data: bytes) -> int:
    """Highest stream level across a (possibly concatenated) .bz2 buffer:
    every stream header is byte-aligned ('BZh' + level + the 48-bit block
    magic), so a scan for that 10-byte pattern finds each one; a false
    positive can only grow the bucket."""
    lvl = max(1, min(9, data[3] - 0x30))
    pos = 0
    while True:
        pos = data.find(b"BZh", pos + 1)
        if pos < 0 or pos + 10 > len(data):
            return lvl
        l2 = data[pos + 3] - 0x30
        if (1 <= l2 <= 9
                and data[pos + 4:pos + 10] == b"\x31\x41\x59\x26\x53\x59"):
            lvl = max(lvl, l2)


def _peek_bits(data: bytes, bit: int, n: int) -> int | None:
    b0 = bit // 8
    need = (bit % 8 + n + 7) // 8
    chunk = data[b0:b0 + need]
    if len(chunk) < need:
        return None
    v = int.from_bytes(chunk, "big")
    return (v >> (8 * need - (bit % 8) - n)) & ((1 << n) - 1)


def _eos_ok(data: bytes, end_bits_abs, crcs) -> bool:
    """After every block the next 48 bits must be a block magic (the
    stream goes on) or the end-of-stream magic followed by the running
    combined CRC (the stream ends and the fold restarts); the last block
    must end a stream. Concatenated streams pass."""
    combined = 0
    for i, e in enumerate(end_bits_abs):
        combined = (((combined << 1) | (combined >> 31))
                    ^ int(crcs[i])) & 0xFFFFFFFF
        nxt = _peek_bits(data, int(e), 48)
        if nxt == EOS_MAGIC:
            if _peek_bits(data, int(e) + 48, 32) != combined:
                return False
            combined = 0
        elif nxt != BLOCK_MAGIC:                       # next block
            return False
    return combined == 0


def _spans(scan: dict) -> np.ndarray:
    """Each block's slice width in bytes: from the byte of its first
    symbol bit to one past its slice end (the next block magic)."""
    return ((scan["end_bits"] + 7) // 8 + 1
            - scan["sym_bits"] // 8).astype(np.int64)


def _fill_slices(data: bytes, scan: dict, out: np.ndarray) -> None:
    """Write each block's bytes over its span into the zeroed rows of
    `out` [nb, scap] (every span already checked to fit)."""
    sb = np.frombuffer(data, np.uint8)
    for b, span in enumerate(_spans(scan)):
        s0 = int(scan["sym_bits"][b]) // 8
        take = min(int(span), len(data) - s0)
        out[b, :take] = sb[s0:s0 + take]


def _scan_or_none(scan, data: bytes):
    """A host scan's result, or None where it refuses the stream or finds
    it corrupt or truncated: the host decoder then decides (and raises)."""
    try:
        return scan(data)
    except CompressionError:
        return None


_SCAN_KEYS = ("sym_bits", "end_bits", "origs", "crcs", "n_useds", "nts",
              "nsels", "mtf_init", "selectors", "lens")


def group_inputs(datas, scans, N: int):
    """The walk's host inputs for streams `datas` of one bucket N with
    their header scans: (the scans concatenated, slices [nb, N +
    SLICE_SLACK] uint8, each block's bytes from the byte of its first
    symbol bit, zero-padded)."""
    scan = {k: np.concatenate([s[k] for s in scans]) for k in _SCAN_KEYS}
    slices = np.zeros((len(scan["sym_bits"]), N + SLICE_SLACK), np.uint8)
    b0 = 0
    for data, s in zip(datas, scans):
        cnt = len(s["sym_bits"])
        _fill_slices(data, s, slices[b0:b0 + cnt])
        b0 += cnt
    return scan, slices


def _decode_group(datas, items, N: int, device, stage_hook):
    """Decode the streams `items` ((index, scan)) of one bucket N.
    Returns {index: plaintext or None (declined)}."""
    with span("bzip2.slices"):
        level = max(_max_level(datas[i]) for i, _ in items)
        rec_cap = bzip2_walk.rec_cap_for(level)
        scan, slices = group_inputs([datas[i] for i, _ in items],
                                    [s for _, s in items], N)
    nb = len(scan["sym_bits"])
    parts = []
    for b0 in range(0, nb, MAX_DISPATCH_BLOCKS):
        part = {k: v[b0:b0 + MAX_DISPATCH_BLOCKS] for k, v in scan.items()}
        parts.append(bzip2_walk.decode_blocks_device(
            part, slices[b0:b0 + MAX_DISPATCH_BLOCKS], N, device, rec_cap,
            stage_hook))
    with span("bzip2.eos"):
        plain, lens, err, endbits = (parts[0] if len(parts) == 1 else
                                     map(np.concatenate, zip(*parts)))
        flat = plain.reshape(-1)
    out = {}
    b0 = 0
    for i, s in items:
        cnt = len(s["sym_bits"])
        sl = slice(b0, b0 + cnt)
        out[i] = None
        with stage("bzip2", "eos", stage_hook):
            ok = np.count_nonzero(err[sl]) == 0 and _eos_ok(
                datas[i],
                (s["sym_bits"] // 8) * 8 + endbits[sl].astype(np.int64),
                s["crcs"])
        if ok:
            with stage("bzip2", "rle1-inverse", stage_hook):
                try:
                    out[i] = oracle.bzip2_rle1_inverse(
                        flat, np.arange(b0, b0 + cnt, dtype=np.int64) * N,
                        lens[sl].astype(np.int64), s["crcs"])
                except DataError:
                    pass
        b0 += cnt
    return out


def decompress_walk_many(datas, device="cuda", stage_hook=_nohook) -> list:
    """Batch decode on the device: every stream's blocks of one level
    bucket share one dispatch. Entries come back None where the device
    path declines the stream."""
    device = _device(device)
    datas = [bytes(d) for d in datas]
    results = [None] * len(datas)
    groups = {}
    with stage("bzip2", "scan", stage_hook):
        for i, data in enumerate(datas):
            if len(data) < 4:
                continue
            s = _scan_or_none(oracle.bzip2_scan_headers, data)
            if s is None or len(s["sym_bits"]) == 0:
                continue
            N = _bucket(bzip2_walk.rec_cap_for(_max_level(data)))
            if int(_spans(s).max()) <= N + SLICE_SLACK:
                groups.setdefault(N, []).append((i, s))
    for N, items in groups.items():
        for i, out in _decode_group(datas, items, N, device,
                                    stage_hook).items():
            results[i] = out
    return results


def decompress_many(datas, device="cuda", stage_hook=_nohook) -> list[bytes]:
    """Batch decode; streams the device path declines decode on the host
    (counted in host_declines)."""
    datas = [bytes(d) for d in datas]
    outs = decompress_walk_many(datas, device, stage_hook)
    return [o if o is not None else _host_decode(d)
            for o, d in zip(outs, datas)]


def decompress_walk(data: bytes, device="cuda") -> bytes | None:
    """The device route for one stream, or None where it declines."""
    return decompress_walk_many([data], device)[0]


def _decompress_last_route(data: bytes, device) -> bytes | None:
    """The second device route: the host decodes every block's symbols to
    its BWT last column (cpp Bzip2ScanToLast) and the device runs the
    inverse BWT. None where either declines. Counted in
    host_symbol_decodes."""
    global host_symbol_decodes
    host_symbol_decodes += 1
    scan = _scan_or_none(oracle.bzip2_scan_to_last, data)
    if scan is None:
        return None
    blob, offs, lens, origs, crcs = scan
    nb = len(offs)
    if nb == 0:
        return b""
    N = _bucket(int(lens.max()))
    last = np.zeros((nb, N), np.uint8)
    for b in range(nb):
        last[b, :lens[b]] = blob[offs[b]:offs[b] + lens[b]]
    rows = ibwt_blocks_fast(last, lens, origs, device)
    if rows is None:
        return None
    try:
        return oracle.bzip2_rle1_inverse(
            rows.reshape(-1), np.arange(nb, dtype=np.int64) * N, lens, crcs)
    except DataError:
        # A CRC miss here may be the device path's; the host decoder
        # re-checks and is authoritative.
        return None


def decompress(data: bytes, device="cuda") -> bytes:
    """Decode one stream: the device route, then the second device route
    (host symbol decode + device iBWT, counted in host_symbol_decodes),
    then the host decoder (counted in host_declines)."""
    device = _device(device)
    data = bytes(data)
    out = decompress_walk(data, device)
    if out is None:
        out = _decompress_last_route(data, device)
    return out if out is not None else _host_decode(data)


# ------------------------------------------------------------------ encode

def _level(level: int) -> int:
    return max(1, min(9, int(level)))


def empty_stream(level: int) -> bytes:
    """The stream of b"": the header, the end-of-stream magic and a
    combined CRC of 0, as the oracle writes it."""
    return (b"BZh" + bytes([0x30 + _level(level)])
            + ((EOS_MAGIC << 32) | 0).to_bytes(10, "big"))


def stream_blocks(parts):
    """Every block of some buffers' host RLE1 output (oracle.bzip2_rle1's
    (rle, off, len, crc) each) in stream order, as (bytes, crc, first:
    the block opens its buffer's stream)."""
    return [(rle[o:o + n], int(c), j == 0) for rle, off, ln, crc in parts
            for j, (o, n, c) in enumerate(zip(off, ln, crc))]


def block_rows(blocks):
    """Blocks of stream_blocks as one batch: (rows [NB, N] uint8
    zero-padded to the bucket N, lens [NB] int32, crcs [NB] int64, first
    [NB] bool)."""
    lens = np.array([b.size for b, _, _ in blocks], np.int32)
    rows = np.zeros((lens.size, _bucket(int(lens.max()))), np.uint8)
    for i, (b, _, _) in enumerate(blocks):
        rows[i, :b.size] = b
    return (rows, lens, np.array([c for _, c, _ in blocks], np.int64),
            np.array([f for _, _, f in blocks], bool))


def mtf_input(last: torch.Tensor, n: torch.Tensor):
    """The BWT last columns [NB, N] and lengths [NB] -> (v [NB, N] int32,
    each live byte's index among the block's used bytes, 0 past n; used
    [NB, 256] int32 0/1)."""
    NB, N = last.shape
    live = torch.arange(N, device=last.device)[None, :] < n[:, None]
    used = torch.zeros((NB, 257), dtype=torch.int32, device=last.device)
    used.scatter_(1, torch.where(live, last, 256).to(torch.int64), 1)
    used = used[:, :256].contiguous()
    to_seq = torch.cumsum(used, dim=1, dtype=torch.int32) - 1
    v = torch.gather(to_seq, 1, torch.where(live, last, 0).to(torch.int64))
    return torch.where(live, v, 0).contiguous(), used


def _fused_bwt_mtf(rows: torch.Tensor, n: torch.Tensor, stage_hook):
    """BWT, used-byte map, MTF and RLE2 of the uint8 rows [NB, N] with
    lengths n [NB] int32, on their device. Returns (orig, syms, sym_len,
    used, n_used)."""
    with stage("bzip2", "words", stage_hook):
        w = cyclic_words_device(rows, n)
    with stage("bzip2", "bwt", stage_hook):
        last, orig = bwt_batched(w, n)
        del w
    with stage("bzip2", "mtf", stage_hook):
        v, used = mtf_input(last, n)
        ranks = mtf_ranks(v, n)
        del last, v
    with stage("bzip2", "rle2", stage_hook):
        syms, sym_len = rle2_encode(ranks, n)
    return orig, syms, sym_len, used, used.sum(dim=1, dtype=torch.int32)


def _encode_dispatch(blocks, pos: int, device, stage_hook):
    """One device dispatch for `blocks` (stream_blocks), the first of which
    starts at bit `pos` of the batch's layout (a block that opens a stream
    starts word-aligned after a 32-bit gap for its header). Returns (w0,
    words uint32: the layout's words w0 onward, holding these blocks' bits
    and zeros elsewhere; body_off, total_bits [NB] int64: each block's bit
    offset in the layout and its length; the bit where the last ends)."""
    def dev(a):
        return torch.from_numpy(a).to(device)

    with span("bzip2.words"):
        rows, lens, crcs, first = block_rows(blocks)
        n, rows = dev(lens), dev(rows)
    orig, syms, sym_len, used, n_used = _fused_bwt_mtf(rows, n, stage_hook)
    with stage("bzip2", "plan", stage_hook):
        vals, nbits, total_bits = encode_blocks(
            syms, sym_len, used, n_used, orig.to(torch.int32), dev(crcs))
        del syms
    with stage("bzip2", "pack", stage_hook):
        tb = total_bits.cpu().numpy()
        w0 = pos // 32
        body_off = np.zeros_like(tb)
        for b in range(tb.size):
            if first[b]:
                pos = (pos + 31) // 32 * 32 + 32
            body_off[b] = pos
            pos += int(tb[b])
        words = assemble_stream_msb(vals, nbits, dev(body_off - 32 * w0),
                                    -(-pos // 32) - w0)
        del vals, nbits
    with stage("bzip2", "fetch", stage_hook):
        words = words.cpu().numpy().astype(np.uint32)
    return w0, words, body_off, tb, pos


def _splice_eos(body: bytearray, end_bit: int, crcs) -> bytes:
    """Append the 48-bit end-of-stream magic and the 32-bit combined CRC
    at `end_bit` (blocks are not byte-aligned), padded to a byte."""
    combined = 0
    for c in crcs:
        combined = (((combined << 1) | (combined >> 31)) ^ int(c)) \
            & 0xFFFFFFFF
    tail_bits = (EOS_MAGIC << 32) | combined          # 80 bits
    sh = end_bit & 7
    nbytes = (sh + 80 + 7) // 8
    # The partial byte's high bits, then the trailer.
    head = body[end_bit // 8] >> (8 - sh) if sh else 0
    v = ((head << 80) | tail_bits) << (8 * nbytes - sh - 80)
    del body[end_bit // 8:]
    body += v.to_bytes(nbytes, "big")
    return bytes(body)


def encode_layout(blocks, device, stage_hook=_nohook):
    """Encode `blocks` (stream_blocks) in dispatches of at most
    MAX_DISPATCH_BLOCKS into one bit layout. Returns (body uint8: the
    layout's bytes, MSB first; body_off, total_bits [NB] int64: each
    block's bit offset in it and its length)."""
    pos, parts = 0, []
    for g in range(0, len(blocks), MAX_DISPATCH_BLOCKS):
        w0, words, off, tb, pos = _encode_dispatch(
            blocks[g:g + MAX_DISPATCH_BLOCKS], pos, device, stage_hook)
        parts.append((w0, words, off, tb))
    with span("bzip2.frame"):
        layout = np.zeros(max(w0 + w.size for w0, w, _, _ in parts),
                          np.uint32)
        for w0, words, _, _ in parts:
            layout[w0:w0 + words.size] |= words
        return (layout.astype(">u4").view(np.uint8),
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts]))


def compress_many(datas, level: int = 9, device="cuda",
                  stage_hook=_nohook) -> list[bytes]:
    """Batched bzip2 encode: every buffer's blocks share one device
    dispatch (several above MAX_DISPATCH_BLOCKS blocks); the host runs
    only RLE1 and the framing. Byte-identical to oracle.bzip2_encode."""
    device = _device(device)
    level = _level(level)
    datas = [bytes(d) for d in datas]
    results = [empty_stream(level) if not d else None for d in datas]
    todo = [i for i, d in enumerate(datas) if d]
    # ctypes releases the GIL: the buffers' RLE1 runs on parallel threads,
    # inside this thread's span.
    with stage("bzip2", "rle1", stage_hook), ThreadPoolExecutor(
            max(1, min(len(todo), os.cpu_count() or 1))) as pool:
        items = list(zip(todo, pool.map(
            lambda i: oracle.bzip2_rle1(datas[i], level), todo)))
    if not items:
        return results
    with span("bzip2.words"):
        blocks = stream_blocks([p for _, p in items])
    body, body_off, tb = encode_layout(blocks, device, stage_hook)
    hdr = b"BZh" + bytes([0x30 + level])
    with stage("bzip2", "frame", stage_hook):
        b0 = 0
        for i, (_, _, ln, crc) in items:
            nb = ln.size
            start_bit = int(body_off[b0]) - 32              # word-aligned
            end_bit = int(body_off[b0 + nb - 1] + tb[b0 + nb - 1])
            buf = bytearray(
                body[start_bit // 8:(end_bit + 7) // 8].tobytes())
            buf[0:4] = hdr
            results[i] = _splice_eos(buf, end_bit - start_bit, crc)
            b0 += nb
    return results


def compress(data: bytes, level: int = 9, device="cuda") -> bytes:
    return compress_many([data], level, device)[0]
