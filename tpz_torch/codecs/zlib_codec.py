"""zlib container (RFC 1950): CMF/FLG header + DEFLATE + Adler-32 trailer
(port of tpz/codecs/zlib_codec.py). The Adler-32 is stdlib zlib's. The
body decodes by the segmented route (codecs/deflate.py)."""

from __future__ import annotations

import struct
import zlib

from tpz_torch import constants as C
from tpz_torch import errors
from tpz_torch.codecs import deflate


def header_bytes(level: int = 6) -> bytes:
    cmf = C.ZLIB_CM_DEFLATE | (C.ZLIB_CINFO_32K << 4)
    # FLEVEL advisory bits: 0 fastest .. 3 max.
    flevel = 0 if level <= 1 else (1 if level <= 5 else (2 if level == 6 else 3))
    flg = flevel << 6
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg])


def compress(data: bytes, level: int = 6, *, device="cuda") -> bytes:
    body = deflate.compress(data, level=level, device=device)
    return header_bytes(level) + body + struct.pack(">I", zlib.adler32(data))


def compress_many(datas, level: int = 6, *, device="cuda") -> list[bytes]:
    """Batched zlib: device-batched DEFLATE bodies + per-buffer framing."""
    datas = list(datas)
    bodies = deflate.compress_many(datas, level=level, device=device)
    hdr = header_bytes(level)
    return [hdr + body + struct.pack(">I", zlib.adler32(d))
            for d, body in zip(datas, bodies)]


def check_header(cmf: int, flg: int) -> None:
    """Validate the 2-byte CMF/FLG header (RFC 1950 §2.2)."""
    if (cmf * 256 + flg) % 31 != 0:
        raise errors.DataError("zlib header FCHECK failed")
    if cmf & 0x0F != C.ZLIB_CM_DEFLATE:
        raise errors.DataError(f"unsupported zlib CM {cmf & 0x0f}")
    if flg & 0x20:  # FDICT
        raise errors.DataError("preset dictionaries not supported")


def decompress_prefix(data: bytes, *, device="cuda") -> tuple[bytes, int]:
    """Decode one zlib stream that may be followed by more data. Returns
    (plaintext, consumed bytes including header and trailer)."""
    if len(data) < 6:
        raise errors.UnexpectedEof("zlib stream too short")
    check_header(data[0], data[1])
    plain, consumed = deflate.decompress_prefix(data[2:], device=device)
    trailer = data[2 + consumed:2 + consumed + 4]
    if len(trailer) < 4:
        raise errors.UnexpectedEof("missing adler32 trailer")
    (expect,) = struct.unpack(">I", trailer)
    actual = zlib.adler32(plain)
    if actual != expect:
        raise errors.DataError(f"adler32 mismatch: {actual:#x} != {expect:#x}")
    return plain, 2 + consumed + 4


def decompress(data: bytes, *, device="cuda") -> bytes:
    plain, consumed = decompress_prefix(data, device=device)
    if consumed != len(data):  # RFC 1950 streams are exactly one member
        raise errors.DataError(f"trailing garbage after zlib stream "
                               f"({len(data) - consumed} bytes)")
    return plain
