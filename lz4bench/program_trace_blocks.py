"""The program-span readings of :mod:`lz4bench.program_trace` for cells
whose requests are raw LZ4 blocks (the ``decode_blocks`` entry), and the
program's counters of each recorded request.

``python -m lz4bench.program_trace_blocks --workload <cell> --seed <n>``
takes ``program_trace``'s arguments and runs
:mod:`lz4bench.program_trace_frames` with the decode entry's readings
under ``decode_blocks``: its JSON line (``spans_a_request`` names the
spans each request recorded, ``decode.raw`` among them), then the line
of each recording's counters (``decode.raw.blocks``,
``decode.raw.literal_bytes``, ``decode.chains.*`` among them).  Its exit
code is ``program_trace``'s.
"""

from __future__ import annotations

import sys

from . import program_trace, program_trace_frames


def main(argv=None) -> int:
    program_trace.READINGS.setdefault("decode_blocks",
                                      program_trace.READINGS["decode"])
    return program_trace_frames.main(argv)


if __name__ == "__main__":
    sys.exit(main())
