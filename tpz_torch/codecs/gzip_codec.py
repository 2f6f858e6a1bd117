"""gzip container (RFC 1952), encode side: header + DEFLATE + CRC-32/ISIZE
trailer (port of tpz/codecs/gzip_codec.py). The CRC is stdlib zlib's."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tpz_torch._shared import constants as C
from tpz_torch.codecs import deflate

_FEXTRA = 4

# 'TZ' FEXTRA subfield: the encoder's DEFLATE-block index, which lets a
# decoder decode blocks in parallel; conformant gzip decoders skip unknown
# subfields (RFC 1952 §2.3.1.1). Layout (all LE): u8 version=1, u8
# reserved, u16 nblocks, nblocks x (u32 end_bit_of_block, u32 out_len).
_TZ_ID = b"TZ"
_TZ_MAX_BLOCKS = (65535 - 8) // 8


def header_bytes(level: int = 6, mtime: int = 0, extra: bytes = b"") -> bytes:
    xfl = 2 if level >= 7 else (4 if level <= 1 else 0)
    flg = _FEXTRA if extra else 0
    hdr = C.GZIP_MAGIC + bytes([C.GZIP_CM_DEFLATE, flg]) + struct.pack(
        "<I", mtime) + bytes([xfl, C.GZIP_OS_UNIX])
    if extra:
        hdr += struct.pack("<H", len(extra)) + extra
    return hdr


def _tz_extra(block_bits, block_lens) -> bytes:
    payload = struct.pack("<BBH", 1, 0, len(block_bits)) + np.stack(
        [np.asarray(block_bits, np.uint32),
         np.asarray(block_lens, np.uint32)], axis=1).tobytes()
    return _TZ_ID + struct.pack("<H", len(payload)) + payload


def _trailer(data: bytes) -> bytes:
    return struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


def compress(data: bytes, level: int = 6, *, device, mtime: int = 0,
             index: bool = True) -> bytes:
    """One gzip member; with `index`, the 'TZ' block index rides in
    FEXTRA when it fits."""
    body, block_bits, block_lens = deflate.compress_indexed(
        data, level=level, device=device)
    extra = b""
    if index and len(block_bits) <= _TZ_MAX_BLOCKS:
        extra = _tz_extra(block_bits, block_lens)
    return header_bytes(level, mtime, extra) + body + _trailer(data)


def compress_many(datas, level: int = 6, *, device,
                  mtime: int = 0) -> list[bytes]:
    """Batched gzip: device-batched DEFLATE bodies + per-buffer framing."""
    datas = list(datas)
    bodies = deflate.compress_many(datas, level=level, device=device)
    header = header_bytes(level, mtime)
    return [header + body + _trailer(d) for d, body in zip(datas, bodies)]
