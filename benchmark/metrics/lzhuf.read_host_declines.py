"""Streams of a request that lzhuf_walk handed to the host decoder
because the device path declined their shape (spans
lzhuf.host_decline)."""

from benchmark import readers, spans


def read(rec):
    return spans.count(rec, "lzhuf.host_decline", readers.DECODE)
