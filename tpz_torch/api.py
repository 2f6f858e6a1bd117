"""Public entry points of the port: whole-buffer and batched encode for
"gzip" and "deflate" on an explicit torch device ("cuda" or "cpu")."""

from __future__ import annotations

from tpz_torch.codecs import deflate, gzip_codec

_COMPRESS = {"gzip": gzip_codec.compress, "deflate": deflate.compress}
_COMPRESS_MANY = {"gzip": gzip_codec.compress_many,
                  "deflate": deflate.compress_many}


def _lookup(table: dict, format: str):
    if format not in table:
        raise ValueError(f"unsupported format {format!r}; "
                         f"the port encodes {sorted(table)}")
    return table[format]


def compress(data: bytes, format: str = "gzip", level: int = 6, *,
             device) -> bytes:
    return _lookup(_COMPRESS, format)(data, level, device=device)


def compress_many(datas, format: str = "gzip", level: int = 6, *,
                  device) -> list[bytes]:
    """Batch encode: every buffer's blocks share one device batch; each
    buffer is its own stream."""
    return _lookup(_COMPRESS_MANY, format)(datas, level, device=device)
