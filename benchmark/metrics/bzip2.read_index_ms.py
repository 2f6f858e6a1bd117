"""bzip2 decode's host stages scan (each stream's block headers) and
slices (each block's symbol slice, tables and layout), their spans, ms a
request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["bzip2.scan", "bzip2.slices"],
                         readers.DECODE)
