"""Least time of the profiled decode requests' bytes at the card's
bandwidth over their kernels' time, %."""

from benchmark import readers


def read(rec):
    return readers.roofline_pct(rec, readers.DECODE)
