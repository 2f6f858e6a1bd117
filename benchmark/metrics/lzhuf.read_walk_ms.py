"""lzhuf_walk's device stages walk (the token walk #5), materialize and
resolve (#3), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["walk", "materialize", "resolve"])
