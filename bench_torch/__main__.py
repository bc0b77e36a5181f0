"""``python -m bench_torch [--seed N] [--timed N]``: the port's bench on
one card.

Prints the card's name and power limit first, a breakdown of each
cell's traced run, then one JSON line with every metric by name and
unit.  Without CUDA it exits non-zero before it measures anything; any
failure exits non-zero with the cause on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import corpora, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bench_torch",
        description="lz4tpu_torch's bench: five cells on one CUDA card.")
    ap.add_argument("--seed", type=int, default=corpora.DEFAULT_SEED,
                    help=f"corpus seed (recorded: {sorted(corpora.RECORDED)})")
    ap.add_argument("--timed", type=int, default=run.TIMED,
                    help="timed requests of each single-request cell "
                         f"(default {run.TIMED}; at least 40, so that p75 "
                         "has ten beyond it)")
    args = ap.parse_args(argv)
    if args.timed < run.TIMED:
        ap.error(f"--timed must be at least {run.TIMED}")
    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available; the bench measures the "
              "card and has no CPU fallback", file=sys.stderr)
        return 2
    print(run.card_line(), flush=True)
    try:
        out = run.run(args.seed, args.timed)
    except (run.BenchFailure, corpora.InputChanged) as e:
        print(f"bench_torch: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
