"""``python -m lz4bench --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json`` on the card.

The program's kernel cache is put in ``lz4bench/_build/kernels``, a
fixed directory of the checkout, before the program is imported, so
only the first run in a checkout builds.  Without a CUDA card, or with
fewer than the cell asks for, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lz4bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from lz4bench import harness

    harness.program_environment()
    return harness.main(args.workload, args.seed, args.seconds,
                        bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
