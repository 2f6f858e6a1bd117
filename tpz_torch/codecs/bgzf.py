"""BGZF, htslib's blocked gzip (the SAM/BAM format specification §4.1;
htslib's bgzf.c): BAM, BCF, tabix-indexed .vcf.gz and bgzip's files.

A file is a series of gzip members (RFC 1952). Each member holds at most
BLOCK_INPUT bytes of plaintext as its own raw DEFLATE stream, and its
FEXTRA carries the subfield 'BC' (SLEN 2) that gives BSIZE, the member's
size less one, so no member exceeds MAX_MEMBER bytes. The file ends with
EOF_MARKER, an empty member.

Encode: every object cut into blocks, every block of every object its own
stream of one `deflate_pipeline.compress_many` call, then the members'
framing and the EOF marker (stage "frame", span bgzf.frame).

Decode: each buffer's members split by BSIZE alone, reading only their
headers and trailers (stage "split", span bgzf.split); every member of
every buffer of the call indexed on the host in threads (span
inflate.index) and decoded by one
`inflate_pipeline.decompress_many_segmented` call, whose device batches
split only at MAX_DECODE_SPAN of output; then each member's CRC-32 and
ISIZE (stage "crc", span bgzf.crc). `members` counts the members that
path took. A buffer whose members do not all pass the split is decoded
by `gzip_codec.decompress` (span bgzf.decline) and counted in `declines`.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

from tpz_torch import errors
from tpz_torch.codecs import gzip_codec
from tpz_torch.codecs.deflate import DeflateConfig
from tpz_torch.kernels import deflate_pipeline
from tpz_torch.kernels import inflate_pipeline as ip
from tpz_torch.utils.profiling import _nohook, span, stage

BC = b"BC"
BLOCK_INPUT = 0xFF00      # htslib's BGZF_BLOCK_SIZE: plaintext a member
MAX_MEMBER = 0x10000      # htslib's BGZF_MAX_BLOCK_SIZE: bytes a member
# ID1 ID2 CM FLG(FEXTRA), then MTIME, XFL, OS and XLEN; the 'BC'
# subfield, SLEN 2 and BSIZE follow.
_PREFIX = b"\x1f\x8b\x08\x04"
_HEADER = struct.Struct("<4sIBBH2sHH")
_HEADER_BYTES = _HEADER.size          # 18
_OS_UNKNOWN = 255
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

# Buffers decoded by gzip_codec.decompress because a member failed the
# split, and members that the batched path decoded.
declines = 0
members = 0


def _member_header(level: int, size: int) -> bytes:
    return _HEADER.pack(_PREFIX, 0, gzip_codec.xfl(level), _OS_UNKNOWN, 6,
                        BC, 2, size - 1)


def compress_many(datas, level: int = 6, *, device="cuda",
                  stage_hook=_nohook) -> list[bytes]:
    """One BGZF file an object: blocks of BLOCK_INPUT bytes (the last
    shorter), all encoded in one device batch up to MAX_DEVICE_SPAN, each
    a member; an empty object is the EOF marker alone. stage_hook sees
    the encode's stages, then "frame"."""
    views = [memoryview(d) for d in datas]
    blocks = [[v[i:i + BLOCK_INPUT] for i in range(0, len(v), BLOCK_INPUT)]
              for v in views]
    bodies = deflate_pipeline.compress_many(
        [b for bs in blocks for b in bs], DeflateConfig(level=level),
        device, stage_hook=stage_hook)
    out = []
    with stage("bgzf", "frame", stage_hook):
        k = 0
        for bs in blocks:
            parts = []
            for b, body in zip(bs, bodies[k:k + len(bs)]):
                size = _HEADER_BYTES + len(body) + 8
                if size > MAX_MEMBER:
                    raise RuntimeError(f"BGZF member of {size} bytes: more "
                                       f"than {MAX_MEMBER}")
                parts += (_member_header(level, size), body,
                          struct.pack("<II", zlib.crc32(b), len(b)))
            parts.append(EOF_MARKER)
            out.append(b"".join(parts))
            k += len(bs)
    return out


def compress(data: bytes, level: int = 6, *, device="cuda") -> bytes:
    return compress_many([data], level, device=device)[0]


# ------------------------------------------------------------- decode

def _bgzf_member(data: bytes, off: int):
    """(member size, body offset) of the BGZF header at `off`: gzip's magic,
    CM 8, FLG FEXTRA alone and a 'BC' subfield of SLEN 2 whose BSIZE
    holds the header and trailer; None for any other header."""
    if data[off:off + 4] != _PREFIX or len(data) - off < _HEADER_BYTES:
        return None
    (xlen,) = struct.unpack_from("<H", data, off + 10)
    body = off + 12 + xlen
    if body > len(data):
        return None
    p = off + 12
    while p + 4 <= body:
        (slen,) = struct.unpack_from("<H", data, p + 2)
        if data[p:p + 2] == BC and slen == 2 and p + 6 <= body:
            size = struct.unpack_from("<H", data, p + 4)[0] + 1
            return (size, body) if size >= body - off + 8 else None
        p += 4 + slen
    return None


def is_bgzf(data: bytes) -> bool:
    """Whether the first member of `data` carries a BGZF header."""
    return _bgzf_member(data, 0) is not None


def split(data: bytes):
    """Each member's (body start, body end, CRC-32, ISIZE), found from
    BSIZE alone; None when a member is not BGZF (no 'BC' subfield, or an
    ISIZE above MAX_MEMBER), or `data` holds none. Raises UnexpectedEof
    for a member that BSIZE runs past the end of `data`, and what the
    gzip reader raises for bytes that no gzip member starts."""
    found = []
    off, n = 0, len(data)
    while off < n:
        got = _bgzf_member(data, off)
        if got is None:
            # Raises as the gzip reader does on bytes that are no member;
            # a gzip member of another kind is declined.
            gzip_codec.parse_header_extra(data, off)
            return None
        size, body = got
        end = off + size
        if end > n:
            raise errors.UnexpectedEof("BGZF member truncated")
        crc, isize = struct.unpack_from("<II", data, end - 8)
        if isize > MAX_MEMBER:
            return None
        found.append((body, end - 8, crc, isize))
        off = end
    return found or None


def _check_index(idx, body: bytes, isize: int) -> None:
    """A body whose stream does not end at the trailer, or whose output
    is not ISIZE bytes, raises DataError before it is decoded."""
    if idx["consumed"] != len(body):
        raise errors.DataError("BGZF member: bytes between the DEFLATE "
                               "stream and the trailer")
    if int(idx["out_lens"].sum()) != isize:
        raise errors.DataError("gzip ISIZE mismatch")


def _host_member(body: bytes) -> bytes:
    """A body the device path declined, decoded by the host inflate."""
    plain, consumed = ip._host_inflate(body)
    if consumed != len(body):
        raise errors.DataError("BGZF member: bytes between the DEFLATE "
                               "stream and the trailer")
    return plain


def _decode(bufs, device, stage_hook) -> list[bytes]:
    """The plaintext of each (buffer, its split) pair: every member of
    every buffer indexed in threads (gzip_codec.THREADS), then decoded
    and checked by gzip_codec.decode_members."""
    global members
    bodies = [d[b0:b1] for d, sp in bufs for b0, b1, _, _ in sp]
    metas = [(crc, isize) for _, sp in bufs for _, _, crc, isize in sp]
    workers = min(len(bodies), gzip_codec.THREADS, os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        run = gzip_codec.runs_in(pool, 4 * workers)
        idxs = ip.index_streams(bodies, run)
        for idx, body, (_, isize) in zip(idxs, bodies, metas):
            if idx is not None:
                _check_index(idx, body, isize)
        ms = iter([(b, x, None if x is not None else _host_member(b), crc,
                    isize)
                   for b, x, (crc, isize) in zip(bodies, idxs, metas)])
        walked = [[next(ms) for _ in sp] for _, sp in bufs]
        out = gzip_codec.decode_members(walked, device, stage_hook, run,
                                        "bgzf")
    members += len(bodies)
    return out


def decompress_many(datas, *, device="cuda",
                    stage_hook=_nohook) -> list[bytes]:
    """Batched BGZF decode: the members of every buffer of the call in
    one batched segmented decode (see the module docstring). stage_hook
    sees "split", the decode's stages (kernels/inflate_pipeline.py),
    then "crc"."""
    global declines
    device = deflate_pipeline._device(device)
    datas = list(datas)
    with stage("bgzf", "split", stage_hook):
        splits = [split(d) for d in datas]
    taken = [i for i, sp in enumerate(splits) if sp is not None]
    results = [None] * len(datas)
    if taken:
        for i, out in zip(taken, _decode([(datas[i], splits[i])
                                          for i in taken], device,
                                         stage_hook)):
            results[i] = out
    for i, sp in enumerate(splits):
        if sp is None:
            declines += 1
            with span("bgzf.decline"):
                results[i] = gzip_codec.decompress(datas[i], device=device,
                                                   stage_hook=stage_hook)
    return results


def decompress(data: bytes, *, device="cuda") -> bytes:
    return decompress_many([data], device=device)[0]
