"""Device encoder: host ms a request inside the program's
device/encode.emit_inputs (span encode.search), which returns the
card's decisions on the host."""

from lz4bench import readers


def read(trace):
    return readers.span_ms(trace, "encode.search")
