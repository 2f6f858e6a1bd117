"""gzip container (RFC 1952): header + DEFLATE + CRC-32/ISIZE trailer
(port of tpz/codecs/gzip_codec.py). The CRC is stdlib zlib's.

Decode handles FEXTRA/FNAME/FCOMMENT/FHCRC and multi-member streams. In
a batched decode a buffer whose first member carries BGZF's 'BC'
subfield goes to the BGZF reader (codecs/bgzf.py). A member whose 'TZ'
side-car passes the bounds checks takes the indexed route; any other
member takes the segmented route (kernels/inflate_pipeline.py). The
trailer checks after a decode are the stage "crc" (the span
tpz_torch.gzip.crc); an encode's header, CRC-32, ISIZE and their join
with the body are the span gzip.frame.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from tpz_torch import constants as C
from tpz_torch import errors
from tpz_torch.codecs import deflate
from tpz_torch.kernels import inflate_pipeline as ip
from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.utils.profiling import _nohook, span, stage

_FTEXT, _FHCRC, _FEXTRA, _FNAME, _FCOMMENT = 1, 2, 4, 8, 16

# 'TZ' FEXTRA subfield: the encoder's DEFLATE-block index, which lets a
# decoder decode blocks in parallel; conformant gzip decoders skip unknown
# subfields (RFC 1952 §2.3.1.1). Layout (all LE): u8 version=1, u8
# reserved, u16 nblocks, nblocks x (u32 end_bit_of_block, u32 out_len).
_TZ_ID = b"TZ"
_TZ_MAX_BLOCKS = (65535 - 8) // 8


def xfl(level: int) -> int:
    """The header's XFL for `level`: 2 for the slowest levels, 4 for the
    fastest."""
    return 2 if level >= 7 else (4 if level <= 1 else 0)


def header_bytes(level: int = 6, mtime: int = 0, extra: bytes = b"") -> bytes:
    flg = _FEXTRA if extra else 0
    hdr = C.GZIP_MAGIC + bytes([C.GZIP_CM_DEFLATE, flg]) + struct.pack(
        "<I", mtime) + bytes([xfl(level), C.GZIP_OS_UNIX])
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


def compress(data: bytes, level: int = 6, *, device="cuda", mtime: int = 0,
             index: bool = True) -> bytes:
    """One gzip member; with `index`, the 'TZ' block index rides in
    FEXTRA when it fits. A buffer the host encodes (above
    MAX_DEVICE_SPAN) has no index, so its member carries no TZ extra."""
    body, block_bits, block_lens = deflate.compress_indexed(
        data, level=level, device=device)
    with span("gzip.frame"):
        extra = b""
        if (index and block_bits is not None
                and len(block_bits) <= _TZ_MAX_BLOCKS):
            extra = _tz_extra(block_bits, block_lens)
        return header_bytes(level, mtime, extra) + body + _trailer(data)


def compress_many(datas, level: int = 6, *, device="cuda",
                  mtime: int = 0) -> list[bytes]:
    """Batched gzip: device-batched DEFLATE bodies + per-buffer framing."""
    datas = list(datas)
    bodies = deflate.compress_many(datas, level=level, device=device)
    with span("gzip.frame"):
        header = header_bytes(level, mtime)
        return [header + body + _trailer(d) for d, body in zip(datas, bodies)]


# ------------------------------------------------------------- decode

def parse_tz_extra(extra: bytes):
    """The 'TZ' subfield's (end_bits, out_lens) int64 arrays, or None."""
    off = 0
    while off + 4 <= len(extra):
        sid = extra[off:off + 2]
        (slen,) = struct.unpack_from("<H", extra, off + 2)
        body = extra[off + 4:off + 4 + slen]
        off += 4 + slen
        if sid != _TZ_ID or len(body) < 4:
            continue
        ver, _, nb = struct.unpack_from("<BBH", body, 0)
        if ver != 1 or len(body) < 4 + 8 * nb:
            continue
        arr = np.frombuffer(body, np.uint32, count=2 * nb,
                            offset=4).reshape(nb, 2)
        return arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64)
    return None


def parse_header_extra(data: bytes, off: int) -> tuple[int, bytes]:
    """Parse a member header; returns (body offset, FEXTRA bytes)."""
    if len(data) - off < 10:
        raise errors.UnexpectedEof("gzip header truncated")
    if data[off:off + 2] != C.GZIP_MAGIC:
        raise errors.DataError("bad gzip magic")
    if data[off + 2] != C.GZIP_CM_DEFLATE:
        raise errors.DataError(f"unsupported gzip CM {data[off + 2]}")
    flg = data[off + 3]
    extra = b""
    pos = off + 10
    if flg & _FEXTRA:
        if len(data) - pos < 2:
            raise errors.UnexpectedEof("FEXTRA truncated")
        (xlen,) = struct.unpack_from("<H", data, pos)
        extra = data[pos + 2:pos + 2 + xlen]
        pos += 2 + xlen
    for flag, name in ((_FNAME, "FNAME"), (_FCOMMENT, "FCOMMENT")):
        if flg & flag:
            end = data.find(b"\x00", pos)
            if end < 0:
                raise errors.UnexpectedEof(f"{name} unterminated")
            pos = end + 1
    if flg & _FHCRC:
        if len(data) - pos < 2:
            raise errors.UnexpectedEof("FHCRC truncated")
        (hcrc,) = struct.unpack_from("<H", data, pos)
        # header CRC16 = low 16 bits of CRC-32 over the header bytes
        if hcrc != zlib.crc32(data[off:pos]) & 0xFFFF:
            raise errors.DataError("gzip header CRC mismatch")
        pos += 2
    if pos > len(data):
        raise errors.UnexpectedEof("gzip header overruns input")
    return pos, extra


def _tz_index_ok(end_bits, out_lens, body_cap: int) -> bool:
    """Bounds checks on the untrusted side-car: a crafted or foreign index
    must not crash or over-allocate; a member that fails them takes the
    segmented route instead."""
    return (len(end_bits) >= 1
            and bool((end_bits[:-1] < end_bits[1:]).all())
            and int(end_bits[0]) > 0
            and (int(end_bits[-1]) + 7) // 8 <= body_cap
            and bool((out_lens[:-1] == ip.BLOCK).all())
            and 0 <= int(out_lens[-1]) <= ip.BLOCK
            and len(end_bits) * ip.BLOCK <= ip.MAX_DECODE_SPAN_WIDE)


def _check_trailer(plain: bytes, crc: int, isize: int) -> None:
    if crc != zlib.crc32(plain):
        raise errors.DataError("gzip CRC mismatch")
    if isize != len(plain) & 0xFFFFFFFF:
        raise errors.DataError("gzip ISIZE mismatch")


def decompress_member_prefix(data: bytes, off: int = 0, *, device="cuda",
                             stage_hook=_nohook) -> tuple[bytes, int]:
    """Decode one member starting at `off`; returns (plaintext, offset
    just past its trailer). stage_hook sees the decode's stages, then
    "crc" after the trailer check."""
    device = _device(device)
    pos, extra = parse_header_extra(data, off)
    idx = parse_tz_extra(extra) if extra else None
    if idx is not None and _tz_index_ok(*idx, len(data) - pos - 8):
        end_bits, out_lens = idx
        consumed = (int(end_bits[-1]) + 7) // 8
        plain = ip.decompress_indexed(data[pos:pos + consumed], end_bits,
                                      out_lens, device, stage_hook=stage_hook)
    else:
        plain, consumed = deflate.decompress_prefix(
            data[pos:], device=device, stage_hook=stage_hook)
    tpos = pos + consumed
    with stage("gzip", "crc", stage_hook):
        if len(data) - tpos < 8:
            raise errors.UnexpectedEof("gzip trailer truncated")
        _check_trailer(plain, *struct.unpack_from("<II", data, tpos))
    return plain, tpos + 8


def decompress(data: bytes, *, device="cuda", stage_hook=_nohook) -> bytes:
    out = _decompress_members_batched(data, device, stage_hook)
    if out is not None:
        return out
    parts = []
    off = 0
    while off < len(data):
        plain, off = decompress_member_prefix(data, off, device=device,
                                              stage_hook=stage_hook)
        parts.append(plain)
    if not data:
        raise errors.UnexpectedEof("empty gzip input")
    return b"".join(parts)


def decompress_many(datas, *, device="cuda", stage_hook=_nohook) -> list[bytes]:
    """Batched gzip decode: the buffers whose first member is BGZF's go
    to its reader (codecs/bgzf.py), which decodes all their members in
    one batched call; every TZ-indexed member of the other buffers shares
    one indexed batch; the rest decode one by one. stage_hook sees each
    decode's stages (kernels/inflate_pipeline.py), then "crc" after its
    trailer checks."""
    from tpz_torch.codecs import bgzf  # bgzf imports this module

    device = _device(device)
    datas = list(datas)
    results = [None] * len(datas)
    marked = [i for i, d in enumerate(datas) if bgzf.is_bgzf(d)]
    if marked:
        for i, out in zip(marked, bgzf.decompress_many(
                [datas[i] for i in marked], device=device,
                stage_hook=stage_hook)):
            results[i] = out
    scans = [_scan_members_indexed(d) if results[i] is None else None
             for i, d in enumerate(datas)]
    items = [it for s in scans if s is not None for it in s[0]]
    if items:
        plains = ip.decompress_many_indexed(items, device,
                                            stage_hook=stage_hook)
        with stage("gzip", "crc", stage_hook):
            pos = 0
            for i, s in enumerate(scans):
                if s is None:
                    continue
                its, metas = s
                part = plains[pos:pos + len(its)]
                for plain, (crc, isize) in zip(part, metas):
                    _check_trailer(plain, crc, isize)
                results[i] = b"".join(part)
                pos += len(its)
    for i, d in enumerate(datas):
        if results[i] is None:
            results[i] = decompress(d, device=device, stage_hook=stage_hook)
    return results


def _scan_members_indexed(data: bytes):
    """Member scan without decoding: (items, metas) for
    decompress_many_indexed when every member carries a valid TZ index,
    else None. metas are each member's (crc, isize)."""
    items = []
    metas = []
    off = 0
    try:
        while off < len(data):
            pos, extra = parse_header_extra(data, off)
            idx = parse_tz_extra(extra) if extra else None
            if idx is None or not _tz_index_ok(*idx, len(data) - pos - 8):
                return None
            end_bits, out_lens = idx
            nbytes = (int(end_bits[-1]) + 7) // 8
            items.append((data[pos:pos + nbytes], end_bits, out_lens))
            tpos = pos + nbytes
            if len(data) - tpos < 8:
                raise errors.UnexpectedEof("gzip trailer truncated")
            metas.append(struct.unpack_from("<II", data, tpos))
            off = tpos + 8
    except (errors.DataError, errors.UnexpectedEof):
        return None
    if not items:
        return None
    return items, metas


def _decompress_members_batched(data: bytes, device,
                                stage_hook=_nohook) -> bytes | None:
    """One buffer's members in one indexed batch when every member
    carries the TZ index; None -> the caller walks members one by one."""
    s = _scan_members_indexed(data)
    if s is None:
        return None
    items, metas = s
    plains = ip.decompress_many_indexed(items, device, stage_hook=stage_hook)
    with stage("gzip", "crc", stage_hook):
        for plain, (crc, isize) in zip(plains, metas):
            _check_trailer(plain, crc, isize)
    return b"".join(plains)
