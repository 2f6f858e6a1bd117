"""Share of the profiled decode requests' wall time in which the device ran
nothing they launched, %."""

from benchmark import readers


def read(rec):
    return readers.idle_pct(rec, readers.DECODE)
