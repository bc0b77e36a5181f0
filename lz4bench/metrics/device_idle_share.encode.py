"""The same as device_idle_share.decode, in the encode cell."""

from lz4bench import readers


def read(trace):
    return readers.idle_share(trace)
