"""Input bytes over the whole window of frames written with the card's help."""

from lz4bench import readers


def read(window):
    return readers.rate_gbps(window)
