"""The host segment index of each stream (inflate_pipeline.index_stream,
span inflate.index, inside the scan stage), ms a request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["inflate.index"], readers.DECODE)
