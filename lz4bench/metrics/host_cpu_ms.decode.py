"""Process CPU ms a traced request, every thread's (getrusage): the
host's part of a decode the card paces (parse, scan, staging copy)."""

from lz4bench import readers


def read(trace):
    return readers.host_cpu_ms(trace)
