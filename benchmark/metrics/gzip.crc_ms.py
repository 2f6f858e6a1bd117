"""The gzip reader's trailer checks: every member's CRC-32 and ISIZE,
taken together for a call (span gzip.crc), ms a request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["gzip.crc"], readers.DECODE)
