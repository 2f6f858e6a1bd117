"""Share of the profiled encode requests' wall time in which the device ran
nothing they launched, %."""

from benchmark import readers


def read(rec):
    return readers.idle_pct(rec, readers.ENCODE)
