"""LZHUF codec: the LHA static-Huffman methods lh4-lh7 on a torch device
(port of tpz/codecs/lzhuf.py).

`raw_compress` / `raw_decompress` handle the raw stream (no size header:
LHA archives carry the original size in the archive header).
`compress` / `decompress` add the reference's minimal container: magic
b"TPZL", the 3-byte method name, the original size as <Q, the body.
Adding and parsing that container is the span lzhuf.frame.

There is no "auto" and no fallback: `device` names where the work runs
and a CUDA device without a card raises. Decode declines only the shapes
the reference declines; those go to the host decoder and are counted in
kernels/lzhuf_walk.host_declines.
"""

from __future__ import annotations

import struct

from tpz_torch import constants as C
from tpz_torch.errors import DataError, UnexpectedEof
from tpz_torch.kernels import lzhuf_pipeline, lzhuf_walk
from tpz_torch.utils.profiling import _nohook, span

_MAGIC = b"TPZL"
_HEADER = 15  # 4 magic + 3 method + 8 size


def _dict_bits(method: str) -> int:
    if method not in C.LZHUF_METHODS:
        raise ValueError(f"unknown lzhuf method {method!r}; have "
                         f"{sorted(C.LZHUF_METHODS)}")
    return C.LZHUF_METHODS[method][0]


def _container(method: str, data: bytes, body: bytes) -> bytes:
    return _MAGIC + method.encode() + struct.pack("<Q", len(data)) + body


def raw_compress(data: bytes, method: str = "lh5", *,
                 device="cuda") -> bytes:
    _dict_bits(method)
    return lzhuf_pipeline.compress(data, method, device)


def raw_decompress(data: bytes, orig_size: int, method: str = "lh5", *,
                   device="cuda") -> bytes:
    return lzhuf_walk.decompress(data, orig_size, _dict_bits(method), device)


def compress(data: bytes, method: str = "lh5", *, device="cuda") -> bytes:
    body = raw_compress(data, method, device=device)
    with span("lzhuf.frame"):
        return _container(method, data, body)


def compress_many(datas, method: str = "lh5", *,
                  device="cuda") -> list[bytes]:
    """Batch encode: every buffer's blocks share one device batch."""
    _dict_bits(method)
    datas = list(datas)
    bodies = lzhuf_pipeline.compress_many(datas, method, device)
    with span("lzhuf.frame"):
        return [_container(method, d, b) for d, b in zip(datas, bodies)]


def _parse(data: bytes, method: str | None):
    if data[:4] != _MAGIC:
        raise DataError("bad lzhuf container magic")
    m = data[4:7].decode(errors="replace")
    if method is not None and m != method:
        raise DataError(f"container method {m} != requested {method}")
    if m not in C.LZHUF_METHODS:
        raise DataError(f"unknown lzhuf method {m!r} in container")
    (size,) = struct.unpack_from("<Q", data, 7)
    return m, size, data[_HEADER:]


def decompress(data: bytes, method: str | None = None, *,
               device="cuda") -> bytes:
    if len(data) < _HEADER:
        raise UnexpectedEof("lzhuf container too short")
    with span("lzhuf.frame"):
        m, size, body = _parse(data, method)
    return raw_decompress(body, size, m, device=device)


def decompress_many(datas, method: str | None = None, *, device="cuda",
                    stage_hook=_nohook) -> list[bytes]:
    """Batch decode: the buffers of each method share one device walk."""
    parsed = []
    with span("lzhuf.frame"):
        for d in datas:
            if len(d) < _HEADER:
                raise DataError("bad lzhuf container magic")
            parsed.append(_parse(d, method))
    results = [None] * len(parsed)
    by_bits = {}
    for i, (m, _, _) in enumerate(parsed):
        by_bits.setdefault(_dict_bits(m), []).append(i)
    for bits, idxs in by_bits.items():
        outs = lzhuf_walk.decompress_many(
            [(parsed[i][2], parsed[i][1]) for i in idxs], bits, device,
            stage_hook=stage_hook)
        for i, o in zip(idxs, outs):
            results[i] = o
    return results
