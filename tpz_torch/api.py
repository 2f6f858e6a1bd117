"""Public entry points of the port: whole-buffer and batched encode and
decode for "gzip", "deflate", "zlib", "bzip2" and the LZHUF methods
"lh4"-"lh7". They run on the card (`device="cuda"`) unless the caller
asks for the CPU (`device="cpu"`); "cuda" without a card raises."""

from __future__ import annotations

import functools

from tpz_torch import constants as C
from tpz_torch.codecs import bzip2, deflate, gzip_codec, lzhuf, zlib_codec

# Each entry is called as fn(data(s), level, device=...) to encode and
# fn(data(s), device=...) to decode. The LZHUF entries bind their method
# and ignore the level (LZHUF has one profile), as the reference's do;
# bzip2 takes the level as its block size in units of 100 k.
_COMPRESS = {"gzip": gzip_codec.compress, "deflate": deflate.compress,
             "zlib": zlib_codec.compress, "bzip2": bzip2.compress}
_COMPRESS_MANY = {"gzip": gzip_codec.compress_many,
                  "deflate": deflate.compress_many,
                  "zlib": zlib_codec.compress_many,
                  "bzip2": bzip2.compress_many}
_DECOMPRESS = {"gzip": gzip_codec.decompress, "deflate": deflate.decompress,
               "zlib": zlib_codec.decompress, "bzip2": bzip2.decompress}
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


def _lookup(table: dict, format: str):
    if format not in table:
        raise ValueError(f"unsupported format {format!r}; "
                         f"the port supports {sorted(table)}")
    return table[format]


def compress(data: bytes, format: str = "gzip", level: int = 6, *,
             device="cuda") -> bytes:
    return _lookup(_COMPRESS, format)(data, level, device=device)


def compress_many(datas, format: str = "gzip", level: int = 6, *,
                  device="cuda") -> list[bytes]:
    """Batch encode: every buffer's blocks share one device batch; each
    buffer is its own stream."""
    return _lookup(_COMPRESS_MANY, format)(datas, level, device=device)


def decompress(data: bytes, format: str = "gzip", *, device="cuda") -> bytes:
    return _lookup(_DECOMPRESS, format)(data, device=device)


def decompress_many(datas, format: str = "gzip", *,
                    device="cuda") -> list[bytes]:
    """Batch decode: gzip puts every TZ-indexed member of every buffer in
    one device batch, the LZHUF methods every buffer's segments and bzip2
    every stream's blocks of one level bucket; other formats decode per
    buffer."""
    fn = _lookup(_DECOMPRESS, format)
    if format in _DECOMPRESS_MANY:
        return _DECOMPRESS_MANY[format](datas, device=device)
    return [fn(d, device=device) for d in datas]
