"""lzhuf_pipeline stages pack (the MSB bit packer), fetch and merge, and
the container's framing (stage frame of the hooked encode,
`benchmark/lzhuf_hooks.py`), ms a request."""

from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, ["pack", "fetch", "merge", "frame"])
