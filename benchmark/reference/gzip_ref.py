"""gzip (RFC 1952) through Python's zlib (libz)."""

from __future__ import annotations

import gzip
import zlib


def encode(data: bytes, level: int) -> bytes:
    """One member as `gzip -<level>` writes it (mtime 0, no name)."""
    return gzip.compress(data, compresslevel=level, mtime=0)


def decode(stream: bytes) -> bytes:
    """The plaintext of exactly one gzip member. libz checks the header,
    the DEFLATE body, the CRC-32 and the ISIZE of the trailer; a member
    that ends early, or bytes after it, raise ValueError."""
    d = zlib.decompressobj(wbits=31)
    out = d.decompress(stream)
    if not d.eof or d.unused_data:
        raise ValueError("not exactly one whole gzip member")
    return out


def break_integrity(stream: bytes) -> bytes:
    """The member with the CRC-32 of its trailer set to 0."""
    return stream[:-8] + b"\0\0\0\0" + stream[-4:]
