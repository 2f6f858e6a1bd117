"""The traced run's LZHUF encode entry.

`api.compress_many(batch, "lh5", level)` takes a level, and
`codecs.lzhuf.compress_many` passes no stage hook down; the harness's
hooked call is `hooked(batch, level, device=, stage_hook=)`, so it
cannot name `lzhuf_pipeline.compress_many`, whose third argument is the
method. Its stages are read here, and the container is added by the
codec's own `_container`, as the stage `frame` (the hook called once
the last container is made). The streams go through the same check as
the window's.
"""

from __future__ import annotations


def lh5_compress_many(datas, level: int, *, device, stage_hook):
    from tpz_torch.codecs import lzhuf
    from tpz_torch.kernels import lzhuf_pipeline

    datas = list(datas)
    bodies = lzhuf_pipeline.compress_many(datas, "lh5", device,
                                          stage_hook=stage_hook)
    out = [lzhuf._container("lh5", d, body)
           for d, body in zip(datas, bodies)]
    stage_hook("frame")
    return out
