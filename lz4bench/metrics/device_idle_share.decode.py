"""The card: 100 - the union of its device operations over the traced
window, in %."""

from lz4bench import readers


def read(trace):
    return readers.idle_share(trace)
