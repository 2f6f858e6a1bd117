"""Entries of the traced run that api's own entry has no stage hook for.

`api.compress_many(..., "gzip", level)` calls `gzip_codec.compress_many`,
which passes no stage hook down. Its stages are read from
`deflate_pipeline.compress_many`, the function under it, with the gzip
framing done here: the same header fields, then the body, then the
CRC-32 and ISIZE trailer. The streams go through the same check as the
window's.
"""

from __future__ import annotations

import struct
import zlib


def gzip_compress_many(datas, level: int, *, device, stage_hook):
    from tpz_torch.codecs.deflate import DeflateConfig
    from tpz_torch.kernels import deflate_pipeline

    bodies = deflate_pipeline.compress_many(
        datas, DeflateConfig(level=level), device, stage_hook=stage_hook)
    xfl = 2 if level >= 7 else (4 if level <= 1 else 0)
    header = b"\x1f\x8b\x08\x00\x00\x00\x00\x00" + bytes([xfl, 3])
    return [header + body + struct.pack("<II", zlib.crc32(d),
                                        len(d) & 0xFFFFFFFF)
            for d, body in zip(datas, bodies)]
