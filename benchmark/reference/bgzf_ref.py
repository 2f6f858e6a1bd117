"""BGZF (the SAM/BAM format specification §4.1, "The BGZF compression
format"; htslib's bgzf.c) through Python's zlib (libz), as htslib's
writer and a strict reader.

A file is a series of gzip members. Each holds at most 65,280 bytes of
plaintext (BGZF_BLOCK_SIZE, 0xff00) as one raw DEFLATE stream, with the
FEXTRA subfield 'BC' (SLEN 2) giving BSIZE, the member's total size less
one, so no member exceeds 65,536 bytes (BGZF_MAX_BLOCK_SIZE). The file
ends with a fixed empty member of 28 bytes, the EOF marker.
"""

from __future__ import annotations

import struct
import zlib

BLOCK = 0xFF00
MAX_BLOCK = 0x10000
# ID1 ID2 CM FLG=FEXTRA, MTIME 0, XFL 0, OS 255, XLEN 6, 'B' 'C', SLEN 2,
# then BSIZE; htslib writes this header on every member.
_HEADER = struct.Struct("<4sIBBH2sHH")
_MAGIC = b"\x1f\x8b\x08\x04"
EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def _member(block: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = c.compress(block) + c.flush()
    size = _HEADER.size + len(body) + 8
    if size > MAX_BLOCK:
        raise ValueError(f"a member of {size} bytes")
    return (_HEADER.pack(_MAGIC, 0, 0, 255, 6, b"BC", 2, size - 1) + body
            + struct.pack("<II", zlib.crc32(block), len(block)))


def encode(data: bytes, level: int) -> bytes:
    """The file htslib's writer (bgzip -l <level>) writes: blocks of
    65,280 bytes, the last shorter, each a member at zlib's `level`, then
    the EOF marker; an empty object is the EOF marker alone."""
    return b"".join(_member(data[i:i + BLOCK], level)
                    for i in range(0, len(data), BLOCK)) + EOF


def _bsize(stream: bytes, off: int, xlen: int) -> int:
    """BSIZE from the one 'BC' subfield of the member at `off`."""
    extra = stream[off + 12:off + 12 + xlen]
    if len(extra) != xlen:
        raise ValueError("FEXTRA truncated")
    found, p = [], 0
    while p < xlen:
        if p + 4 > xlen:
            raise ValueError("a subfield header overruns XLEN")
        si, slen = extra[p:p + 2], struct.unpack_from("<H", extra, p + 2)[0]
        if p + 4 + slen > xlen:
            raise ValueError("a subfield overruns XLEN")
        if si == b"BC":
            if slen != 2:
                raise ValueError(f"'BC' subfield of SLEN {slen}")
            found.append(struct.unpack_from("<H", extra, p + 4)[0])
        p += 4 + slen
    if len(found) != 1:
        raise ValueError(f"{len(found)} 'BC' subfields")
    return found[0]


def decode(stream: bytes) -> bytes:
    """The plaintext of one whole BGZF file. Every member's magic, CM,
    FLG and 'BC' subfield are checked, its BSIZE against where its
    DEFLATE stream and trailer really end, its CRC-32 and ISIZE, and
    ISIZE <= 65,536; the last member must be the EOF marker, with nothing
    after it. Any breach raises ValueError."""
    out, off, last = [], 0, None
    while off < len(stream):
        if len(stream) - off < _HEADER.size:
            raise ValueError("member header truncated")
        magic, _, _, _, xlen = struct.unpack_from("<4sIBBH", stream, off)
        if magic != _MAGIC:
            raise ValueError("not a BGZF member (magic, CM or FLG)")
        end = off + _bsize(stream, off, xlen) + 1
        body = off + 12 + xlen
        if end - 8 < body or end > len(stream):
            raise ValueError("BSIZE outside the file")
        d = zlib.decompressobj(-15)
        plain = d.decompress(stream[body:end - 8])
        if not d.eof or d.unused_data:
            raise ValueError("the DEFLATE stream does not end at the trailer")
        crc, isize = struct.unpack_from("<II", stream, end - 8)
        if crc != zlib.crc32(plain) or isize != len(plain):
            raise ValueError("CRC-32 or ISIZE mismatch")
        if isize > MAX_BLOCK:
            raise ValueError(f"ISIZE {isize} above {MAX_BLOCK}")
        out.append(plain)
        last, off = off, end
    if last is None or last != len(stream) - len(EOF) \
            or stream[last:] != EOF:
        raise ValueError("the file does not end with the EOF marker")
    return b"".join(out)


def break_integrity(stream: bytes) -> bytes:
    """The file with the CRC-32 of its first member set to 0."""
    *_, xlen = struct.unpack_from("<4sIBBH", stream, 0)
    end = _bsize(stream, 0, xlen) + 1
    return stream[:end - 8] + b"\0\0\0\0" + stream[end - 4:]
