"""An encode's framing: the gzip header, CRC-32, ISIZE and their join
with the body (span gzip.frame), or the bzip2 stream headers, end of
stream and the join of the dispatches' words (spans bzip2.frame), ms a
request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["gzip.frame", "bzip2.frame"], readers.ENCODE)
