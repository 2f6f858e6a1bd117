"""The 95th percentile of the latency of every read request of the window,
ms."""

from benchmark import readers


def read(rec):
    return readers.p95_ms(rec, readers.DECODE)
