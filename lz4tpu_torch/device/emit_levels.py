"""The device-emit encoder's prefix levels in one kernel (H8,
``csrc/emit_levels.cu``).

:func:`emit_levels` computes exactly what ``encode._level_deltas``
computes from the gram words in sorted order, but reads the 32 prefix
bytes of each sorted entry straight from the padded buffer (word equality
is byte equality), so the eight gathers go too.  ``encode.
_emit_inputs_device`` takes it for a CUDA buffer and ``_level_deltas``
(the plain version, PyTorch ops) for a CPU one.

``tests/test_torch_emit_levels.py`` holds a numpy model of the kernel's
three passes over tiles against ``_level_deltas`` on the CPU.
"""

from __future__ import annotations

import torch

from .. import _kernels

TILE = 2048             # entries a tile, as in csrc/emit_levels.cu
LEVELS = tuple(range(4, 33, 4))


def emit_levels(buf: torch.Tensor, p_s: torch.Tensor) -> dict:
    """``{k: int32[n_pad]}`` for k = 4, 8, ..., 32, in sorted order: the
    distance from each sorted entry back to its level's best candidate (0:
    none), equal to ``encode._level_deltas`` on the gram words of ``buf``
    gathered by ``p_s``.  ``buf`` is the padded buffer (uint8, n_pad a
    multiple of 1024) and ``p_s`` the positions in sorted order (int32),
    both on one CUDA device.  One launch of H8 (three kernels on the
    current stream, no synchronisation); n_pad bytes and 24 int32 a tile
    of scratch."""
    n_pad = buf.shape[0]
    if n_pad == 0 or n_pad % 1024 or n_pad >= 2**31:
        raise ValueError(f"n_pad must be a positive multiple of 1024 under "
                         f"2**31, got {n_pad}")
    _kernels.check(buf, "buf", torch.uint8, (n_pad,), align=4)
    _kernels.check(p_s, "p_s", torch.int32, (n_pad,))
    if p_s.device != buf.device:
        raise ValueError(f"p_s is on {p_s.device}, buf on {buf.device}")
    dev = buf.device
    n_tiles = -(-n_pad // TILE)
    out = torch.empty((len(LEVELS), n_pad), dtype=torch.int32, device=dev)
    lcp = torch.empty(n_pad, dtype=torch.uint8, device=dev)
    tiles = torch.empty(24 * n_tiles, dtype=torch.int32, device=dev)
    _kernels.launch("emit_levels", "lz4t_emit_levels", dev, buf.data_ptr(),
                    p_s.data_ptr(), n_pad, lcp.data_ptr(), tiles.data_ptr(),
                    out.data_ptr())
    return {k: out[j] for j, k in enumerate(LEVELS)}
