"""Seconds from the process's start to the first timed request: imports,
finding or building the kernels and the oracle, the inputs, the warm-up."""


def read(rec):
    return rec["setup_s"]
