"""Batched bzip2 decode on one torch device (port of the decode half of
tpz/kernels/bzip2_pipeline.py).

Stage by stage (the names `stage_hook` receives):
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

import numpy as np

from tpz_torch import oracle
from tpz_torch.errors import CompressionError, DataError
from tpz_torch.kernels import bzip2_walk
from tpz_torch.kernels.deflate_pipeline import _device, _nohook
from tpz_torch.kernels.ibwt_walk import ibwt_blocks_fast

# Blocks per device dispatch: at N = 2^20 a block holds about 30 MB of
# device memory through the walk, expansion and sort, so this bounds a
# dispatch near 2 GB. It changes no result.
MAX_DISPATCH_BLOCKS = 64
SLICE_SLACK = 8192        # bytes a block's slice may run past its bucket

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
        if nxt == 0x177245385090:                      # EOS
            if _peek_bits(data, int(e) + 48, 32) != combined:
                return False
            combined = 0
        elif nxt != 0x314159265359:                    # next block magic
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
    plain, lens, err, endbits = (parts[0] if len(parts) == 1 else
                                 map(np.concatenate, zip(*parts)))
    flat = plain.reshape(-1)
    out = {}
    b0 = 0
    for i, s in items:
        cnt = len(s["sym_bits"])
        sl = slice(b0, b0 + cnt)
        out[i] = None
        ok = np.count_nonzero(err[sl]) == 0 and _eos_ok(
            datas[i], (s["sym_bits"] // 8) * 8 + endbits[sl].astype(np.int64),
            s["crcs"])
        stage_hook("eos")
        if ok:
            try:
                out[i] = oracle.bzip2_rle1_inverse(
                    flat, np.arange(b0, b0 + cnt, dtype=np.int64) * N,
                    lens[sl].astype(np.int64), s["crcs"])
            except DataError:
                pass
            stage_hook("rle1-inverse")
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
    for i, data in enumerate(datas):
        if len(data) < 4:
            continue
        s = _scan_or_none(oracle.bzip2_scan_headers, data)
        if s is None or len(s["sym_bits"]) == 0:
            continue
        N = _bucket(bzip2_walk.rec_cap_for(_max_level(data)))
        if int(_spans(s).max()) <= N + SLICE_SLACK:
            groups.setdefault(N, []).append((i, s))
    stage_hook("scan")
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
