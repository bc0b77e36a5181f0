"""Staging: ms a request inside the program's pipeline.to_device, each call
ending in a synchronise (span stage)."""

from lz4bench import readers


def read(trace):
    return readers.span_ms(trace, "stage")
