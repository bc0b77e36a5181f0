"""Decode engines and kernels: compressed bytes read once and decoded bytes
written once at the card's peak bandwidth, over the device time inside
the requests, in %."""

from lz4bench import readers


def read(trace):
    return readers.roofline(trace)
