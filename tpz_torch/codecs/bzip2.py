"""bzip2 codec, decode half, on a torch device (port of tpz/codecs/bzip2.py).

There is no "auto" and no backend choice: `device` names where the work
runs, and a CUDA device without a card raises. A stream the device path
declines decodes on the host and is counted in
kernels/bzip2_pipeline.host_declines. Encode and the incremental decoder
are not ported yet.
"""

from __future__ import annotations

from tpz_torch.kernels import bzip2_pipeline
from tpz_torch.kernels.deflate_pipeline import _nohook


def decompress(data: bytes, *, device="cuda") -> bytes:
    return bzip2_pipeline.decompress(data, device)


def decompress_many(datas, *, device="cuda",
                    stage_hook=_nohook) -> list[bytes]:
    """Batch decode: every stream's blocks of one level bucket share one
    device dispatch."""
    return bzip2_pipeline.decompress_many(list(datas), device, stage_hook)
