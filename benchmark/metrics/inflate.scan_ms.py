"""inflate_pipeline stage scan (the host segment scan), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["scan"])
