"""bzip2 through Python's bz2 (libbzip2)."""

from __future__ import annotations

import bz2

EOS_MAGIC = 0x177245385090


def encode(data: bytes, level: int) -> bytes:
    """One stream as `bzip2 -<level>` writes it (blocks of level x 100 k)."""
    return bz2.compress(data, compresslevel=level)


def decode(stream: bytes) -> bytes:
    """The plaintext of exactly one bzip2 stream. libbzip2 checks every
    block's CRC and the stream's combined CRC; a stream that ends early,
    or bytes after it, raise ValueError."""
    d = bz2.BZ2Decompressor()
    out = d.decompress(stream)
    if not d.eof or d.unused_data:
        raise ValueError("not exactly one whole bzip2 stream")
    return out


def break_integrity(stream: bytes) -> bytes:
    """The stream with its combined CRC, the 32 bits after the
    end-of-stream magic, set to 0 (the magic and the CRC are not byte
    aligned: 0-7 pad bits follow them)."""
    tail = 16
    v = int.from_bytes(stream[-tail:], "big")
    for pad in range(8):
        if (v >> (pad + 32)) & ((1 << 48) - 1) == EOS_MAGIC:
            v &= ~(((1 << 32) - 1) << pad)
            return stream[:-tail] + v.to_bytes(tail, "big")
    raise ValueError("no end-of-stream magic in the last bytes")
