"""Harnesses of the port: the A/B harness of the mxu2 route variants
(``ab``, run on the card), the randomized differential soak (``soak``)
and the hand-made kernel edge cases (``edge``).  Nothing here is
reachable from :mod:`lz4tpu_torch.pipeline`."""
