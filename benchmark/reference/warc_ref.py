"""WARC files compressed record at a time (ISO 28500, WARC 1.1 Annex D.2,
"Record-at-time compression"), as Common Crawl writes its .warc.gz files,
through Python's zlib (libz): a record-at-a-time writer and a strict
reader.

Each record is compressed as its own gzip member, and the members are
concatenated, so the file is one valid multi-member gzip file. No member
says how long it is: where one ends, and the next starts, is known only
once its DEFLATE stream has been read to its last block.

Records follow the capture of one page as Common Crawl's files hold it:
a `request` record, a `response` record and a `metadata` record. The
writer cuts an object into records of the sizes below, in that order,
the last record cut where the object ends.
"""

from __future__ import annotations

import struct
import zlib

REQUEST = 768
METADATA = 512
# The response records cycle through these sizes, a mean of 98 KiB.
RESPONSES = (8192, 32768, 98304, 262144)
# Bytes fed to the reader's inflate at a time, so that what it leaves
# unused is never more than this.
_CHUNK = 1 << 16


def record_sizes(n: int) -> list[int]:
    """The sizes of the records an object of n bytes is cut into."""
    sizes, done = [], 0
    while done < n:
        capture, kind = divmod(len(sizes), 3)
        size = (REQUEST, RESPONSES[capture % len(RESPONSES)], METADATA)[kind]
        sizes.append(min(size, n - done))
        done += sizes[-1]
    return sizes


def _member(record: bytes, level: int) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, 31)
    return c.compress(record) + c.flush()


def encode(data: bytes, level: int) -> bytes:
    """The file a record-at-a-time writer writes: each record of the
    object (record_sizes) one gzip member at zlib's `level`, with a plain
    10-byte header (no FEXTRA, FNAME or FCOMMENT), then its CRC-32 and
    ISIZE; an empty object is one empty member."""
    view, out, off = memoryview(data), [], 0
    for size in record_sizes(len(data)) or [0]:
        out.append(_member(view[off:off + size], level))
        off += size
    return b"".join(out)


def _read_member(view: memoryview, off: int) -> tuple[bytes, int]:
    """(plaintext, end) of the member at `off`: libz checks its header,
    its DEFLATE stream, its CRC-32 and its ISIZE; a member cut short, or
    one libz refuses, raises ValueError."""
    d = zlib.decompressobj(31)
    parts, pos = [], off
    try:
        while not d.eof:
            if pos >= len(view):
                raise ValueError("a member cut short")
            chunk = view[pos:pos + _CHUNK]
            parts.append(d.decompress(chunk))
            pos += len(chunk)
    except zlib.error as e:
        raise ValueError(f"a member libz refuses: {e}") from None
    return b"".join(parts), pos - len(d.unused_data)


def decode(stream: bytes) -> bytes:
    """The plaintext of one whole record-at-a-time file: every member
    read to its end with its CRC-32 and ISIZE checked, the next starting
    exactly where it ends; at least one member, and nothing after the
    last. Any breach raises ValueError."""
    view, out, off = memoryview(stream), [], 0
    if not stream:
        raise ValueError("no member")
    while off < len(stream):
        plain, off = _read_member(view, off)
        out.append(plain)
    return b"".join(out)


def break_integrity(stream: bytes) -> bytes:
    """The file with the CRC-32 of its first member set to 0."""
    _, end = _read_member(memoryview(stream), 0)
    return stream[:end - 8] + struct.pack("<I", 0) + stream[end - 4:]
