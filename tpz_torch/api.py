"""Public entry points of the port: whole-buffer and batched encode and
decode for "gzip", "deflate", "zlib", "bzip2", the LZHUF methods
"lh4"-"lh7" and raw "lzss", `formats()` and `register_format`, and the
streaming shapes `CodecStream` (encode, with the crate's Action
semantics) and `DecodeStream`. They run on the card (`device="cuda"`)
unless the caller asks for the CPU (`device="cpu"`); "cuda" without a card
raises. Raw LZSS runs on the host whatever the device, as in the
reference. Each call of `compress`, `compress_many`, `decompress` and
`decompress_many` is the span tpz_torch.api.<entry> (utils/profiling.py),
around the spans of its codec's stages."""

from __future__ import annotations

import functools
import struct

from tpz_torch import constants as C
from tpz_torch import oracle
from tpz_torch.action import Action
from tpz_torch.codecs import bzip2, deflate, gzip_codec, lzhuf, lzss
from tpz_torch.codecs import zlib_codec
from tpz_torch.errors import DataError, UnexpectedEof
from tpz_torch.kernels.deflate_pipeline import _device
from tpz_torch.utils.profiling import span

# Each entry is called as fn(data(s), level, device=...) to encode and
# fn(data(s), device=...) to decode. The LZHUF entries bind their method
# and ignore the level (LZHUF has one profile), as the reference's do;
# bzip2 takes the level as its block size in units of 100 k. A format
# without a batched entry is encoded and decoded a buffer at a time.
_COMPRESS = {"gzip": gzip_codec.compress, "deflate": deflate.compress,
             "zlib": zlib_codec.compress, "bzip2": bzip2.compress,
             "lzss": lzss.compress}
_COMPRESS_MANY = {"gzip": gzip_codec.compress_many,
                  "deflate": deflate.compress_many,
                  "zlib": zlib_codec.compress_many,
                  "bzip2": bzip2.compress_many}
_DECOMPRESS = {"gzip": gzip_codec.decompress, "deflate": deflate.decompress,
               "zlib": zlib_codec.decompress, "bzip2": bzip2.decompress,
               "lzss": lzss.decompress}
_DECOMPRESS_MANY = {"gzip": gzip_codec.decompress_many,
                    "bzip2": bzip2.decompress_many}
for _m in sorted(C.LZHUF_METHODS):
    _COMPRESS[_m] = (lambda data, level, *, device, _m=_m:
                     lzhuf.compress(data, _m, device=device))
    _COMPRESS_MANY[_m] = (lambda datas, level, *, device, _m=_m:
                          lzhuf.compress_many(datas, _m, device=device))
    _DECOMPRESS[_m] = functools.partial(lzhuf.decompress, method=_m)
    _DECOMPRESS_MANY[_m] = functools.partial(lzhuf.decompress_many,
                                             method=_m)


def register_format(name: str, compress_fn, decompress_fn) -> None:
    """Add (or replace) a format: compress_fn(data, level, *, device) and
    decompress_fn(data, *, device). Its `*_many` calls loop over the
    buffers; the batched entries of the other formats stay."""
    _COMPRESS[name] = compress_fn
    _DECOMPRESS[name] = decompress_fn
    _COMPRESS_MANY.pop(name, None)
    _DECOMPRESS_MANY.pop(name, None)


def formats() -> list[str]:
    return sorted(_COMPRESS)


def _lookup(table: dict, format: str):
    if format not in table:
        raise ValueError(f"unknown format {format!r}; have {formats()}")
    return table[format]


def compress(data: bytes, format: str = "gzip", level: int = 6, *,
             device="cuda") -> bytes:
    with span("api.compress"):
        return _lookup(_COMPRESS, format)(data, level, device=device)


def compress_many(datas, format: str = "gzip", level: int = 6, *,
                  device="cuda") -> list[bytes]:
    """Batch encode: every buffer's blocks share one device batch; each
    buffer is its own stream. Formats without a batched encoder (raw
    LZSS) loop over the buffers."""
    fn = _lookup(_COMPRESS, format)
    with span("api.compress_many"):
        if format in _COMPRESS_MANY:
            return _COMPRESS_MANY[format](datas, level, device=device)
        return [fn(d, level, device=device) for d in datas]


def decompress(data: bytes, format: str = "gzip", *, device="cuda") -> bytes:
    with span("api.decompress"):
        return _lookup(_DECOMPRESS, format)(data, device=device)


def decompress_many(datas, format: str = "gzip", *,
                    device="cuda") -> list[bytes]:
    """Batch decode: gzip puts every TZ-indexed member of every buffer in
    one device batch, the LZHUF methods every buffer's segments and bzip2
    every stream's blocks of one level bucket; other formats decode per
    buffer."""
    fn = _lookup(_DECOMPRESS, format)
    with span("api.decompress_many"):
        if format in _DECOMPRESS_MANY:
            return _DECOMPRESS_MANY[format](datas, device=device)
        return [fn(d, device=device) for d in datas]


# Formats whose streams concatenate into one logical stream for the
# decoder (gzip members, RFC 1952 §2.2; bzip2 streams, as the `bzip2` tool
# reads them).
_CONCAT_OK = frozenset({"gzip", "bzip2"})
# The DEFLATE family: a true in-stream flush (a Z_SYNC_FLUSH empty stored
# block; one header, one trailer, one stream).
_DEFLATE_FAMILY = frozenset({"deflate", "zlib", "gzip"})
_LZHUF = frozenset(C.LZHUF_METHODS)


class CodecStream:
    """Streaming encode with the crate's Action semantics (reference
    src/action.rs Action::{Run, Flush, Finish}, [HIGH] SURVEY.md §2.1).

    write(b) buffers input (Action::Run); flush() forces a byte-aligned
    segment boundary (Action::Flush) and returns the compressed bytes of
    the buffered data; finish() ends the stream (Action::Finish).

    For deflate, zlib and gzip a flush is in-stream: each segment's blocks
    carry BFINAL=0 and end with a Z_SYNC_FLUSH empty stored block (the
    oracle encodes those segments, as in the reference), the container
    header goes out once and the trailer covers all the plaintext, so the
    output is one valid stream. A bzip2 flush emits an independent stream
    (a valid multi-stream concatenation). lzss and lh4-lh7 have no
    concatenable form, and their flush raises DataError.

    finish() with no flush before it is `compress` on `device`; after a
    flush, the final segment is `deflate.compress` on `device`. On the card
    both run the v3 parse walk kernel."""

    def __init__(self, format: str = "gzip", level: int = 6, *,
                 device="cuda") -> None:
        if format not in _COMPRESS:
            raise ValueError(f"unknown format {format!r}")
        _device(device)
        self._format = format
        self._level = level
        self._device = device
        self._buf = bytearray()
        self._finished = False
        self._header_emitted = False
        self._total = 0
        self._crc_state = 0xFFFFFFFF  # gzip running CRC-32 (before the xor)
        self._adler_state = 1  # zlib running Adler-32

    def write(self, data: bytes) -> None:
        if self._finished:
            raise DataError("stream already finished")
        self._buf += data

    def _deflate_header(self) -> bytes:
        if self._header_emitted:
            return b""
        self._header_emitted = True
        if self._format == "gzip":
            return gzip_codec.header_bytes(self._level)
        if self._format == "zlib":
            return zlib_codec.header_bytes(self._level)
        return b""

    def _account(self, data: bytes) -> None:
        self._total += len(data)
        if self._format == "gzip":
            self._crc_state = oracle.crc32_reflected(data, self._crc_state)
        elif self._format == "zlib":
            self._adler_state = oracle.adler32(data, self._adler_state)

    def _take(self) -> bytes:
        data = bytes(self._buf)
        self._buf.clear()
        return data

    def flush(self) -> bytes:
        if self._finished:
            raise DataError("stream already finished")
        if self._format in _DEFLATE_FAMILY:
            if not self._buf:
                return b""
            data = self._take()
            self._account(data)
            return self._deflate_header() + deflate.compress_flush(
                data, self._level)
        if self._format in _CONCAT_OK:
            if not self._buf:
                return b""
            return compress(self._take(), self._format, self._level,
                            device=self._device)
        raise DataError(
            f"format {self._format!r} has no concatenable stream form; "
            f"Action::Flush is not supported (use Run/Finish)")

    def finish(self) -> bytes:
        if self._finished:
            raise DataError("stream already finished")
        self._finished = True
        data = self._take()
        if self._format not in _DEFLATE_FAMILY:
            return compress(data, self._format, self._level,
                            device=self._device)
        self._account(data)
        if not self._header_emitted:
            # No flush ever happened: the whole-buffer path, whose bytes
            # are compress()'s.
            return compress(data, self._format, self._level,
                            device=self._device)
        # The final segment continues the flushed stream: its last block
        # carries BFINAL, then the container trailer over all the data.
        body = deflate.compress(data, self._level, device=self._device)
        if self._format == "gzip":
            return body + struct.pack("<II", self._crc_state ^ 0xFFFFFFFF,
                                      self._total & 0xFFFFFFFF)
        if self._format == "zlib":
            return body + struct.pack(">I", self._adler_state)
        return body

    def drive(self, data: bytes, action: Action) -> bytes:
        """The crate's single entry point: feed bytes and an Action."""
        self.write(data)
        if action is Action.RUN:
            return b""
        if action is Action.FLUSH:
            return self.flush()
        return self.finish()


class _MemberInflate:
    """One resumable raw-DEFLATE stream (the oracle's InflateStream). It
    tracks the bytes fed against those consumed, so the bytes past the
    stream's end (a container trailer, the next member) come back from
    the chunk that finished it."""

    def __init__(self) -> None:
        self._s = oracle.InflateStream()
        self._fed = 0
        self.done = False
        self.extra = b""  # bytes past the stream's end

    def feed(self, data: bytes) -> bytes:
        out = self._s.feed(data)
        self._fed += len(data)
        if self._s.finished:
            self.done = True
            overshoot = self._fed - self._s.consumed
            # The decoder never consumes past the final end-of-block, so
            # the overshoot all comes from the chunk that finished it.
            self.extra = data[len(data) - overshoot:] if overshoot else b""
            self._s.close()
        return out


class DecodeStream:
    """Streaming decode (parity: the crate's DecodeExt iterator adapters,
    [HIGH] SURVEY.md §2.1).

    write(b) feeds compressed bytes and returns the plaintext that became
    decodable (a member at a time for gzip, a block for bzip2, as tokens
    complete for deflate, zlib and lh4-lh7); finish() returns the rest and
    raises UnexpectedEof if the stream is incomplete, DataError on
    trailing garbage after a completed one-stream format.

    It runs on the host, as the reference's does, and takes no device:
    the DEFLATE family through the C++ resumable InflateStream with
    running checksums, bzip2 through codecs.bzip2.IncrementalDecoder (a
    block decodes on the C++ decoder as soon as the next magic arrives),
    lh4-lh7 through the C++ LzhufStream. Each costs O(total bytes) across
    any write pattern. The reference's decode stream reaches no device
    route either: the device walks take whole indexed streams, and a
    stream fed in pieces has no index. Raw lzss (and a registered format)
    retries a whole decode, on the host, at each write."""

    def __init__(self, format: str = "gzip") -> None:
        if format not in _DECOMPRESS:
            raise ValueError(f"unknown format {format!r}")
        self._format = format
        self._buf = bytearray()  # header or trailer bytes, or the input
        self._finished = False
        if format in _DEFLATE_FAMILY:
            self._state = "body" if format == "deflate" else "header"
            self._inf: _MemberInflate | None = None
            self._plain = bytearray()  # the current member, not yet out
            self._crc = 0xFFFFFFFF
            self._adler = 1
            self._any_input = False
        elif format == "bzip2":
            self._state = "bz2"
            self._inc = bzip2.IncrementalDecoder()
        elif format in _LZHUF:
            self._state = "lzhuf-header"
            self._lzh = None
        else:
            self._state = "buffered"

    # ----------------------------------------------- the DEFLATE family
    def _pump(self, data: bytes) -> bytes:
        out = bytearray()
        buf = data
        while True:
            if self._state == "header":
                self._buf += buf
                buf = b""
                if self._format == "zlib":
                    if len(self._buf) < 2:
                        break
                    zlib_codec.check_header(self._buf[0], self._buf[1])
                    buf = bytes(self._buf[2:])
                else:
                    try:
                        pos, _ = gzip_codec.parse_header_extra(
                            bytes(self._buf), 0)
                    except UnexpectedEof:
                        break
                    buf = bytes(self._buf[pos:])
                self._buf.clear()
                self._inf = _MemberInflate()
                self._state = "body"
            elif self._state == "body":
                if self._inf is None:
                    self._inf = _MemberInflate()
                if not buf and not self._inf.done:
                    break
                chunk = self._inf.feed(buf)
                buf = b""
                if chunk:
                    self._plain += chunk
                    if self._format == "gzip":
                        self._crc = oracle.crc32_reflected(chunk, self._crc)
                    elif self._format == "zlib":
                        self._adler = oracle.adler32(chunk, self._adler)
                if not self._inf.done:
                    break
                buf = self._inf.extra
                self._inf = None
                self._state = "trailer"
            elif self._state == "trailer":
                self._buf += buf
                buf = b""
                if self._format == "deflate":
                    out += self._plain
                    self._plain.clear()
                    self._state = "done"
                    continue
                need = 8 if self._format == "gzip" else 4
                if len(self._buf) < need:
                    break
                if self._format == "gzip":
                    crc, isize = struct.unpack_from("<II", self._buf, 0)
                    if crc != self._crc ^ 0xFFFFFFFF:
                        raise DataError("gzip CRC mismatch")
                    if isize != len(self._plain) & 0xFFFFFFFF:
                        raise DataError("gzip ISIZE mismatch")
                    self._crc = 0xFFFFFFFF
                else:
                    (expect,) = struct.unpack_from(">I", self._buf, 0)
                    if expect != self._adler:
                        raise DataError(
                            f"adler32 mismatch: {self._adler:#x} != "
                            f"{expect:#x}")
                out += self._plain
                self._plain.clear()
                buf = bytes(self._buf[need:])
                self._buf.clear()
                # gzip: more members may follow; zlib: exactly one.
                self._state = "header" if self._format == "gzip" else "done"
                if self._state == "header" and not buf:
                    break
            else:  # done
                self._buf += buf
                break
        return bytes(out)

    def _pump_final(self) -> None:
        if self._state == "done":
            if self._buf:
                raise DataError(
                    f"trailing garbage after {self._format} stream")
            return
        if self._state == "header":
            if not self._buf:
                return  # a clean end at a member boundary
            if self._format == "gzip":
                # Raises UnexpectedEof (truncated) or DataError (garbage).
                gzip_codec.parse_header_extra(bytes(self._buf), 0)
            raise UnexpectedEof(f"{self._format} header truncated")
        if self._state == "body" and self._format == "deflate" \
                and not self._any_input:
            return  # nothing was ever written
        raise UnexpectedEof(f"{self._format} stream truncated")

    # ------------------------------------------------------------ others
    def _drain_buffered(self, final: bool) -> bytes:
        # Emit once the input so far decodes whole.
        if not self._buf:
            return b""
        try:
            plain = decompress(bytes(self._buf), self._format, device="cpu")
        except UnexpectedEof:
            if final:
                raise
            return b""
        self._buf.clear()
        return plain

    def _lzhuf_write(self, data: bytes) -> bytes:
        if self._state == "lzhuf-header":
            self._buf += data
            if len(self._buf) < lzhuf._HEADER:
                return b""
            if bytes(self._buf[:4]) != lzhuf._MAGIC:
                raise DataError("bad lzhuf container magic")
            # Method bytes that are not UTF-8 fail the comparison below
            # with DataError (the reference raises UnicodeDecodeError,
            # ROADMAP R9).
            m = bytes(self._buf[4:7]).decode(errors="replace")
            if m != self._format:
                raise DataError(f"container method {m} != {self._format}")
            (size,) = struct.unpack_from("<Q", self._buf, 7)
            self._lzh = oracle.LzhufStream(C.LZHUF_METHODS[m][0], size)
            body = bytes(self._buf[lzhuf._HEADER:])
            self._buf.clear()
            self._state = "lzhuf-body"
            return self._lzh.feed(body)
        return self._lzh.feed(data)

    # ----------------------------------------------------------- surface
    def write(self, data: bytes) -> bytes:
        if self._finished:
            raise DataError("decode stream already finished")
        if self._state == "bz2":
            return self._inc.write(data)
        if self._state in ("lzhuf-header", "lzhuf-body"):
            return self._lzhuf_write(data)
        if self._state == "buffered":
            self._buf += data
            return self._drain_buffered(final=False)
        if data:
            self._any_input = True
        return self._pump(data)

    def finish(self) -> bytes:
        if self._finished:
            raise DataError("decode stream already finished")
        self._finished = True
        if self._state == "bz2":
            return self._inc.finish()
        if self._state in ("lzhuf-header", "lzhuf-body"):
            out = self._lzhuf_write(b"")
            if self._state == "lzhuf-header" and not self._buf:
                raise UnexpectedEof("empty lzhuf input")
            if self._lzh is None or not self._lzh.finished:
                raise UnexpectedEof(f"{self._format} stream truncated")
            self._lzh.close()
            return out
        if self._state == "buffered":
            return self._drain_buffered(final=True)
        out = self._pump(b"")
        self._pump_final()
        return out
