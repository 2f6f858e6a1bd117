"""lzhuf_pipeline stages screen (the v1 hash screen) and parse (the v1
parse walk #4), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["screen", "parse"])
