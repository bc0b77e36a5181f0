"""Device verify: ms a request inside pipeline._verify_checksums_device,
ending in a synchronise (span verify)."""

from lz4bench import readers


def read(trace):
    return readers.span_ms(trace, "verify")
