"""Fragment text: ``n`` bytes drawn uniformly from 2048 printable
fragments of 5-39 bytes, short repeats that stay in the program's fused
engine.  The fragments are the same for every seed (drawn from
``FRAGMENT_SEED``); the seed draws which come.  Copied from the
program's earlier bench (``bench_torch/corpora.py``, ``frag_text``),
which drew the fragments from the seed."""

import numpy as np

FRAGMENT_SEED = 1


def make(n: int, rng: np.random.Generator) -> np.ndarray:
    n_frag, lo, hi = 2048, 5, 39
    fixed = np.random.default_rng(FRAGMENT_SEED)
    frags = [fixed.integers(32, 127, int(fixed.integers(lo, hi + 1)),
                            dtype=np.uint8) for _ in range(n_frag)]
    mean = np.mean([f.size for f in frags])
    picks = rng.integers(0, n_frag, int(n / mean * 1.1) + 16)
    out = np.concatenate([frags[i] for i in picks])
    if out.size < n:
        raise RuntimeError("fragment corpus came out short")
    return out[:n]
