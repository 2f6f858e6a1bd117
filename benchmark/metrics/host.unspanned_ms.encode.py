"""An encode request's device-idle time that no program span below its
api span covers: host work the spans do not name, ms."""

from benchmark import readers, spans


def read(rec):
    return spans.unspanned_ms(rec, readers.ENCODE)
