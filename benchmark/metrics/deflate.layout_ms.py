"""deflate_pipeline's host layout of a request's buffers (span_layout)
and its copy to the device, spans deflate.layout and deflate.h2d inside
the words stage, ms a request."""

from benchmark import readers, spans


def read(rec):
    return spans.span_ms(rec, ["deflate.layout", "deflate.h2d"],
                         readers.ENCODE)
