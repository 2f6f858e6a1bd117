"""bzip2_pipeline stages mtf, rle2, plan and pack of an encode, their
spans, ms a request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["bzip2.mtf", "bzip2.rle2", "bzip2.plan",
                               "bzip2.pack"], readers.ENCODE)
