"""Buffers of a request that the BGZF reader handed to the gzip reader
because a member failed its split (spans bgzf.decline)."""

from benchmark import readers, spans


def read(rec):
    return spans.count(rec, "bgzf.decline", readers.DECODE)
