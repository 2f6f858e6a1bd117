"""Plaintext MB encoded by the requests the window completed, per second of
the window."""

from benchmark import readers


def read(rec):
    return readers.rate_MBps(rec, readers.ENCODE)
