"""bzip2 encode stage rle1 (host RLE1, block split, CRCs), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["rle1"])
