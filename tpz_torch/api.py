"""Public entry points of the port: whole-buffer and batched encode and
decode for "gzip", "deflate" and "zlib" on an explicit torch device
("cuda" or "cpu")."""

from __future__ import annotations

from tpz_torch.codecs import deflate, gzip_codec, zlib_codec

_COMPRESS = {"gzip": gzip_codec.compress, "deflate": deflate.compress,
             "zlib": zlib_codec.compress}
_COMPRESS_MANY = {"gzip": gzip_codec.compress_many,
                  "deflate": deflate.compress_many,
                  "zlib": zlib_codec.compress_many}
_DECOMPRESS = {"gzip": gzip_codec.decompress, "deflate": deflate.decompress,
               "zlib": zlib_codec.decompress}


def _lookup(table: dict, format: str):
    if format not in table:
        raise ValueError(f"unsupported format {format!r}; "
                         f"the port supports {sorted(table)}")
    return table[format]


def compress(data: bytes, format: str = "gzip", level: int = 6, *,
             device) -> bytes:
    return _lookup(_COMPRESS, format)(data, level, device=device)


def compress_many(datas, format: str = "gzip", level: int = 6, *,
                  device) -> list[bytes]:
    """Batch encode: every buffer's blocks share one device batch; each
    buffer is its own stream."""
    return _lookup(_COMPRESS_MANY, format)(datas, level, device=device)


def decompress(data: bytes, format: str = "gzip", *, device) -> bytes:
    return _lookup(_DECOMPRESS, format)(data, device=device)


def decompress_many(datas, format: str = "gzip", *, device) -> list[bytes]:
    """Batch decode: gzip puts every TZ-indexed member of every buffer in
    one device batch; other formats and other members decode per
    buffer."""
    fn = _lookup(_DECOMPRESS, format)
    if format == "gzip":
        return gzip_codec.decompress_many(datas, device=device)
    return [fn(d, device=device) for d in datas]
