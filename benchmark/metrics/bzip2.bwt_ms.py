"""bzip2 encode stages words and bwt (the BWT sort), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["words", "bwt"])
