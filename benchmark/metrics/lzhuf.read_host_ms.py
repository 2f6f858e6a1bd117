"""lzhuf_walk's host stages index (the container's parse and the token
indexer), tables (each block's decode tables) and layout, ms a
request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["index", "tables", "layout"])
