"""bzip2 codec on a torch device (port of tpz/codecs/bzip2.py).

There is no "auto" and no backend choice: `device` names where the work
runs, and a CUDA device without a card raises. Encode runs every
non-empty buffer on the device (the host does RLE1 and the framing). A
stream the device decode declines decodes on the host and is counted in
kernels/bzip2_pipeline.host_declines. The incremental decoder is not
ported yet.
"""

from __future__ import annotations

from tpz_torch.kernels import bzip2_pipeline
from tpz_torch.kernels.deflate_pipeline import _nohook


def compress(data: bytes, level: int = 9, *, device="cuda") -> bytes:
    return bzip2_pipeline.compress(data, level, device)


def compress_many(datas, level: int = 9, *, device="cuda",
                  stage_hook=_nohook) -> list[bytes]:
    """Batch encode: every buffer's blocks share one device dispatch; each
    buffer is its own stream."""
    return bzip2_pipeline.compress_many(list(datas), level, device,
                                        stage_hook)


def decompress(data: bytes, *, device="cuda") -> bytes:
    return bzip2_pipeline.decompress(data, device)


def decompress_many(datas, *, device="cuda",
                    stage_hook=_nohook) -> list[bytes]:
    """Batch decode: every stream's blocks of one level bucket share one
    device dispatch."""
    return bzip2_pipeline.decompress_many(list(datas), device, stage_hook)
