"""The program-span readings of :mod:`lz4bench.program_trace` for cells
whose requests are many frames (the ``decode_frames`` entry), and the
program's counters of each recorded request.

``python -m lz4bench.program_trace_frames --workload <cell> --seed <n>``
takes ``program_trace``'s arguments and runs it with the decode entry's
readings under ``decode_frames``.  After its JSON line it prints one
more: ``counters``, each recording's counters in the order they were
opened (the traced requests first, then the recorded turns of the cost
timing), as ``decode.frames``, ``decode.blocks``,
``decode.chains.sparse``/``.fused``/``.dense``/``.resolve``,
``decode.fused.isolated`` and ``h2d_bytes``.  Its exit code is
``program_trace``'s.
"""

from __future__ import annotations

import contextlib
import json
import sys

from . import program_trace


def main(argv=None) -> int:
    program_trace.READINGS.setdefault("decode_frames",
                                      program_trace.READINGS["decode"])
    seen = []
    real = program_trace.recording

    def recording():
        rec_open = real()
        if rec_open is None:
            return None

        @contextlib.contextmanager
        def opened():
            with rec_open() as prog:
                yield prog
            seen.append(dict(sorted(prog.counters.items())))

        return opened

    program_trace.recording = recording
    try:
        rc = program_trace.main(argv)
    finally:
        program_trace.recording = real
    print(json.dumps({"counters": seen}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
