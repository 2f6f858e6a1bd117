"""The BGZF reader's member split: each buffer's members found from
BSIZE, reading only their headers and trailers (span bgzf.split), ms a
request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["bgzf.split"], readers.DECODE)
