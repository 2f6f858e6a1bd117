"""deflate_pipeline stage bitpack (the LSB bit packer), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["bitpack"])
