"""Frame bytes over input bytes of the traced requests, in %."""

from lz4bench import readers


def read(trace):
    return readers.ratio(trace)
