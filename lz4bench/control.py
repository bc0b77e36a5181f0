"""The check's control and its planted faults: runs of a cell with the
timed path replaced, each of which has to come out not correct.

``python -m lz4bench.control --workload <name> --seeds 1,2,3 --seconds
<s> --mode <mode>`` runs the cell on the card once a seed, in one
process, with the entry point replaced as ``mode`` says, and prints each
run's numbers compared beside their limits.  It exits 0 when every run
came out not correct, 1 otherwise.  The benchmark's own runs never run
it.

Modes, for a decode cell (``lz4tpu_torch.decompress_to_device``):

* ``control``: the plain reference in the program's place, with the
  configuration's content-checksum guarantee broken: it decodes every
  frame (:func:`reference.decode_unverified`) and checks no checksum;
* ``alter``: the program, with one byte of each answer altered where it
  is produced;
* ``half``: the program, with the second half of each answer left
  unwritten (zero).

For an encode cell (``lz4tpu_torch.compress``):

* ``control``: the reference encoder (the benchmark's frozen copy) in
  the program's place, writing frames without the content checksum the
  configuration states;
* ``alter``: the program, with one byte of each frame altered;
* ``half``: the program, encoding only the first half of each input.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

MODES = ("control", "alter", "half")


def _decode_fault(mode: str, real):
    import numpy as np
    import torch

    from . import reference

    def control(data, reservation=None, *, device="cuda", verify="host",
                **_kw):
        raw = reference.decode_unverified(bytes(data))
        return torch.from_numpy(
            np.frombuffer(bytearray(raw), np.uint8)).to(device)

    def alter(*args, **kwargs):
        out = real(*args, **kwargs)
        out[out.numel() // 2] ^= 1
        return out

    def half(*args, **kwargs):
        out = real(*args, **kwargs)
        out[out.numel() // 2:] = 0
        return out

    return {"control": control, "alter": alter, "half": half}[mode]


def _encode_fault(mode: str, real):
    import numpy as np

    from . import encoder

    def control(data, *, level=6, backend=None, device=None, **flags):
        return encoder.compress_frame(np.frombuffer(data, np.uint8),
                                      dict(flags, content_checksum=False),
                                      level)

    def alter(*args, **kwargs):
        frame = bytearray(real(*args, **kwargs))
        frame[len(frame) // 2] ^= 1
        return bytes(frame)

    def half(data, **kwargs):
        return real(data[:len(data) // 2], **kwargs)

    return {"control": control, "alter": alter, "half": half}[mode]


@contextlib.contextmanager
def planted(entry: str, mode: str):
    """Within: the program's entry point of ``entry`` replaced by
    ``mode``."""
    import lz4tpu_torch

    attr = {"decode": "decompress_to_device", "encode": "compress"}[entry]
    real = getattr(lz4tpu_torch, attr)
    make = _decode_fault if entry == "decode" else _encode_fault
    setattr(lz4tpu_torch, attr, make(mode, real))
    try:
        yield
    finally:
        setattr(lz4tpu_torch, attr, real)


def run_planted(cell, seed: int, seconds: float, mode: str, device: str,
                size: int | None = None) -> dict:
    from . import harness

    with planted(cell.traffic["entry"], mode):
        return harness.run(cell, seed, seconds, False, device,
                           time.perf_counter(), size=size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lz4bench.control",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    args = ap.parse_args(argv)
    from . import harness

    harness.program_environment()
    cell = harness.load_cell(args.workload)
    flipped = 0
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        result = run_planted(cell, seed, args.seconds, args.mode, "cuda")
        flipped += not result["correct"]
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0 if flipped == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
