"""Raw-block front: ms a request inside the program's pipeline._raw_front
(span raw_front): the block table, the token scan and the plan of a
request of raw LZ4 blocks.  None where the program has no such front."""

from lz4bench import readers


def read(trace):
    return readers.span_ms(trace, "raw_front")
