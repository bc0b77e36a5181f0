"""Random bytes, as the reference's ``test_benchmark.sh:6-20`` takes
from ``/dev/urandom``, here from the seed."""

import numpy as np


def make(n: int, rng: np.random.Generator) -> np.ndarray:
    return np.frombuffer(bytearray(rng.bytes(n)), np.uint8)
