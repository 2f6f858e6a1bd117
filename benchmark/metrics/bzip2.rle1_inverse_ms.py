"""bzip2 decode's host stages eos (the end-of-stream checks) and
rle1-inverse (RLE1^-1 and the block CRCs), their spans, ms a request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["bzip2.eos", "bzip2.rle1-inverse"],
                         readers.DECODE)
