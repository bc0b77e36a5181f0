"""Decoded bytes over the whole window, closed loop, of the decodes the
card paces (refbench-256m)."""

from lz4bench import readers


def read(window):
    return readers.rate_gbps(window)
