"""The 64 KiB history ring shared by the fused and mxu2 route kernels.

The port keeps the ring as a flat ``(65536,)`` uint8 tensor: flat index
= chain output position mod 64 Ki, the layout of
``lz4tpu.device.fused.golden_decode``'s ``ring_init``.  The JAX package
keeps it as a ``(256, 256)`` bf16 array of the same bytes;
:func:`ring_from_jax` and :func:`ring_to_jax` convert (full 64 KiB ring
only: the narrow rings of ``fused.fused_rpages`` are a TPU FLOP cut that
the Hopper kernels do not take).

A launch covers substeps ``[p0, p1)`` of a prep (one part when a chain
is split across launches).  :func:`part_segments` cuts that range into
one segment per chain, each run by one block of the route kernel: a
segment starts from a zero ring, or from ``ring_in`` when its chain
began before ``p0`` (ring carry between parts) or when the caller seeded
the first chain's ring.  The last segment's final ring is ``ring_out``.
"""

from __future__ import annotations

import numpy as np
import torch

RING = 65536
SUB = 2048


def ring_from_jax(ring_bf16) -> torch.Tensor:
    """JAX ring ``(256, 256)`` (bf16 or any real dtype holding byte
    values) -> the port's ``(65536,)`` uint8 ring on the CPU."""
    arr = np.asarray(ring_bf16)
    if arr.shape != (256, 256):
        raise ValueError(f"ring must be (256, 256), got {arr.shape}")
    return torch.from_numpy(
        arr.astype(np.float32).astype(np.uint8).reshape(-1))


def ring_to_jax(ring_u8: torch.Tensor) -> np.ndarray:
    """The port's ``(65536,)`` uint8 ring -> a ``(256, 256)`` float32
    array of the same byte values; ``jnp.asarray(r, jnp.bfloat16)`` of
    it is exact (bytes are bf16-representable)."""
    if tuple(ring_u8.shape) != (RING,) or ring_u8.dtype != torch.uint8:
        raise ValueError("ring must be a (65536,) uint8 tensor")
    return ring_u8.cpu().numpy().astype(np.float32).reshape(256, 256)


def part_segments(out_spans, p0: int, p1: int, seeded: bool) -> list:
    """``[(lo, hi, carry)]`` relative to ``p0``, one per chain with
    substeps in ``[p0, p1)``; ``seeded``: the caller passed a ring for
    the first chain of the prep."""
    segs = []
    for (_cid, slo, shi, _n) in out_spans:
        lo, hi = max(slo, p0), min(shi, p1)
        if hi > lo:
            carry = slo < p0 or (seeded and slo == 0)
            segs.append((lo - p0, hi - p0, int(carry)))
    return segs


def segments_array(segs: list) -> np.ndarray:
    return np.array(segs, np.int32).reshape(-1, 3)


def segments_tensor(segs: list, device) -> torch.Tensor:
    from . import to_device

    return to_device(segments_array(segs), device)


def zero_ring(device) -> torch.Tensor:
    return torch.zeros(RING, dtype=torch.uint8, device=device)
