"""deflate_pipeline stages parse (the v3 walk) and plan (histograms and
Huffman planning), their spans, ms a request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["deflate.parse", "deflate.plan"],
                         readers.ENCODE)
