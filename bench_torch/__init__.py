"""The bench of ``lz4tpu_torch``, run as ``python -m bench_torch``.

It imports torch, numpy and ``lz4tpu_torch``, and makes its corpora
from a seed (:mod:`bench_torch.corpora`); :mod:`bench_torch.run` holds
the cells' loops, the traced run and the JSON line.
"""
