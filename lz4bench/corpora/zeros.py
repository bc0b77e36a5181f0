"""Zero bytes, as the reference's ``test_benchmark.sh:6-20`` makes with
``/dev/zero``."""

import numpy as np


def make(n: int, rng: np.random.Generator) -> np.ndarray:
    return np.zeros(n, np.uint8)
