"""lz4bench: the benchmark of ``lz4tpu_torch`` on one NVIDIA H100.

``python -m lz4bench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` from the root of a checkout
and prints one JSON line.  See :mod:`lz4bench.harness`.
"""
