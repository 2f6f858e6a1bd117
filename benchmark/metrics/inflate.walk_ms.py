"""inflate_pipeline stages walk, resolve and materialize, ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["walk", "resolve", "materialize"])
