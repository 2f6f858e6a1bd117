"""bzip2 decode host stages scan, slices, eos and rle1-inverse, ms a
request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["scan", "slices", "eos", "rle1-inverse"])
