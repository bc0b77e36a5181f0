"""Host splice: host ms a request inside the program's
native.emit_quantized (span encode.splice)."""

from lz4bench import readers


def read(trace):
    return readers.span_ms(trace, "encode.splice")
