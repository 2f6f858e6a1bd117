"""gzip container (RFC 1952): header + DEFLATE + CRC-32/ISIZE trailer
(port of tpz/codecs/gzip_codec.py). The CRC is stdlib zlib's.

Decode handles FEXTRA/FNAME/FCOMMENT/FHCRC and multi-member streams. In
a batched decode a buffer whose first member carries BGZF's 'BC'
subfield goes to the BGZF reader (codecs/bgzf.py). The buffers whose
every member carries a 'TZ' side-car that passes the bounds checks share
one batch of the indexed route. Every other buffer, of one member or of
many (a WARC file compressed record at a time, ISO 28500 Annex D.2, is
hundreds), takes the member walk: a gzip member has no field that gives
its size, so each member's end is found by indexing its body with the
host segment index, in place, and each buffer is walked in a host thread
(one span inflate.index for the call). Then every member of every buffer
is decoded by one batched segmented decode (kernels/inflate_pipeline.py),
which splits into device batches only at MAX_DECODE_SPAN of output, and
`members` counts them. The trailer checks after a decode are the stage
"crc" (the span tpz_torch.gzip.crc); an encode's header, CRC-32, ISIZE
and their join with the body are the span gzip.frame.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpz_torch import constants as C
from tpz_torch import errors, oracle
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


# Host threads of the member walks, the members' index and their CRCs
# (here and in codecs/bgzf.py). On an H100's host of 8 cores that other
# work shares, 4 threads read a bgzf.read request as fast as 8 and ~1.2x
# as fast as 2, but their rate swung twice as far from run to run as 2
# threads' did.
THREADS = 2

# Members that the member walk's batched path decoded.
members = 0


def runs_in(pool, parts: int):
    """A map(fn, items) that runs fn over `parts` runs of the items, each
    a task for a thread of `pool`: a task an item would cost more than a
    small member's work, and more runs than threads let the threads on
    free cores take the runs of one that another process holds up."""
    def run(fn, items):
        items = list(items)
        out = [None] * len(items)
        n = min(parts, len(items))
        for k, part in enumerate(pool.map(lambda p: [fn(x) for x in p],
                                           [items[k::n] for k in range(n)])):
            out[k::n] = part
        return out
    return run


def _walk(data: bytes) -> list:
    """Each member of a buffer, in order: (body, index, plaintext,
    CRC-32, ISIZE). A gzip member has no field that gives its size, so
    its body ends where the host segment index (inflate_pipeline._index,
    read in place from the body's offset) says it was consumed; the
    index is kept for the decode. A body the index declines is inflated
    on the host here, which also gives its end: its index is None and
    its plaintext set (else None). The caller counts those declines, on
    its own thread."""
    n = len(data)
    if not n:
        raise errors.UnexpectedEof("empty gzip input")
    view = memoryview(data)
    found, off = [], 0
    while off < n:
        pos, _ = parse_header_extra(data, off)
        idx = ip._index(data, offset=pos)
        plain = None
        if idx is None:
            with span("inflate.host_decline"):
                plain, consumed = oracle.inflate(view[pos:])
        else:
            consumed = idx["consumed"]
        tpos = pos + consumed
        if n - tpos < 8:
            raise errors.UnexpectedEof("gzip trailer truncated")
        crc, isize = struct.unpack_from("<II", data, tpos)
        found.append((view[pos:tpos], idx, plain, crc, isize))
        off = tpos + 8
    return found


def decode_members(walked, device, stage_hook, run,
                   layer: str = "gzip") -> list[bytes]:
    """The plaintext of each buffer from its members, as _walk gives
    them: every member with an index decoded by one
    `inflate_pipeline.decompress_many_segmented` call, whose device
    batches split only at MAX_DECODE_SPAN of output; then every member's
    CRC-32 and ISIZE, `run` (a map) taking the CRCs (stage "crc", span
    <layer>.crc), and each buffer's members joined."""
    ms = [m for w in walked for m in w]
    decoded = iter(ip.decompress_many_segmented(
        [(m[0], m[1]) for m in ms if m[1] is not None], device,
        stage_hook=stage_hook))
    plains = [next(decoded) if m[1] is not None else m[2] for m in ms]
    with stage(layer, "crc", stage_hook):
        crcs = run(zlib.crc32, plains)
        for plain, crc, m in zip(plains, crcs, ms):
            if crc != m[3]:
                raise errors.DataError("gzip CRC mismatch")
            if len(plain) & 0xFFFFFFFF != m[4]:
                raise errors.DataError("gzip ISIZE mismatch")
        out, k = [], 0
        for w in walked:
            out.append(b"".join(plains[k:k + len(w)]))
            k += len(w)
    return out


def _decode_walked(datas, device, stage_hook) -> list[bytes]:
    """Buffers of stock members: every buffer walked member by member in
    host threads, a buffer a thread (one span inflate.index), then all
    their members in decode_members."""
    global members
    workers = min(len(datas), THREADS, os.cpu_count() or 1)
    oracle.lib()  # loaded once, before any thread calls it
    with ThreadPoolExecutor(workers) as pool:
        with span("inflate.index"):
            walked = list(pool.map(_walk, datas))
        ip.host_declines += sum(m[1] is None for w in walked for m in w)
        out = decode_members(walked, device, stage_hook,
                             runs_in(pool, 4 * workers))
    members += sum(map(len, walked))
    return out


def _decode(datas, device, stage_hook) -> list[bytes]:
    """Buffers whose every member carries a valid TZ index share one
    indexed batch, then their trailer checks; every other buffer takes
    the member walk (_decode_walked)."""
    results = [None] * len(datas)
    scans = [_scan_members_indexed(d) for d in datas]
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
    rest = [i for i, s in enumerate(scans) if s is None]
    if rest:
        for i, out in zip(rest, _decode_walked([datas[i] for i in rest],
                                               device, stage_hook)):
            results[i] = out
    return results


def decompress(data: bytes, *, device="cuda", stage_hook=_nohook) -> bytes:
    """One buffer of one or more members, as decompress_many decodes a
    buffer that is not BGZF's."""
    return _decode([data], _device(device), stage_hook)[0]


def decompress_many(datas, *, device="cuda", stage_hook=_nohook) -> list[bytes]:
    """Batched gzip decode: the buffers whose first member is BGZF's go
    to its reader (codecs/bgzf.py); every TZ-indexed member of the
    buffers whose members all carry the index shares one indexed batch;
    every member of every other buffer is found by the member walk and
    decoded in one batched segmented decode. stage_hook sees each
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
    rest = [i for i, r in enumerate(results) if r is None]
    for i, out in zip(rest, _decode([datas[i] for i in rest], device,
                                    stage_hook)):
        results[i] = out
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

