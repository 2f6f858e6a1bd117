"""deflate_pipeline stage screen (the v3 matchfinder screen), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["screen"])
