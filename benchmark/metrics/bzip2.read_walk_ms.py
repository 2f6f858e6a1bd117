"""bzip2 decode device stages walk, expand, sort and ibwt, ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["walk", "expand", "sort", "ibwt"])
