"""Median api request (hooked rotation) less the same request's hooked
stages: what the api entry and its codec do outside the program's stages
(gzip's header, CRC-32 and trailer among it) in an encode, ms."""

from benchmark import readers


def read(rec):
    return readers.self_ms(rec, readers.ENCODE)
