"""Sparse-chain decoder (port of ``lz4tpu.device.sparse_decode``).

Zeros/RLE and incompressible chains spend their bytes in a few giant
segments; the host builds a small program of copy / fill / self ops
(``lz4tpu.device.sparse_decode.build_sparse_program``, reused as is).
Here the program runs as PyTorch slicing on the staged compressed
tensor — data movement, as XLA ran it in the JAX package — except the
fill of whole 512 KiB blocks, which is kernel H2 (``csrc/block_fill.cu``)
behind :func:`block_fill`, with :func:`block_fill_plain` as its plain
PyTorch version for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from lz4tpu.device.sparse_decode import (  # noqa: F401  (re-exported)
    SparseProgram,
    _plan_block_fill,
    build_sparse_program,
)

from .. import _kernels
from . import to_device

FILL_BLK = 1 << 19      # block-fill block (512 KiB)


def block_fill(vals: torch.Tensor) -> torch.Tensor:
    """uint8 ``(n_b * FILL_BLK,)``: block ``b`` holds the byte
    ``vals[b] & 255`` (``vals``: int32 ``(n_b,)``)."""
    if vals.device.type == "cpu":
        return block_fill_plain(vals)
    n_b = vals.shape[0]
    _kernels.check(vals, "vals", torch.int32, (n_b,), align=4)
    out = torch.empty(n_b * FILL_BLK, dtype=torch.uint8, device=vals.device)
    _kernels.launch("block_fill", "lz4t_block_fill", vals.device,
                    vals.data_ptr(), n_b, out.data_ptr())
    return out


def block_fill_plain(vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_fill`."""
    return (vals & 255).to(torch.uint8).repeat_interleave(FILL_BLK)


def _pattern(pattern: bytes, rel: int, n: int, device) -> torch.Tensor:
    """Bytes ``[rel, rel + n)`` of the pattern repeated without end."""
    if len(set(pattern)) == 1:            # uniform byte -> memset
        return torch.full((n,), pattern[0], dtype=torch.uint8,
                          device=device)
    pat = np.frombuffer(pattern, np.uint8)
    reps = -(-(rel + n) // pat.size)
    return to_device(np.tile(pat, reps)[rel:rel + n], device)


def decode_sparse_device(program: SparseProgram,
                         comp: torch.Tensor) -> torch.Tensor:
    """Run the program on ``comp``'s device (``comp``: the whole
    compressed buffer as a uint8 tensor); returns a new uint8 tensor of
    at least ``program.n_out`` bytes (block fills pad to whole blocks)."""
    ops, n_out = program.ops, program.n_out
    dev = comp.device
    plan = _plan_block_fill(ops, n_out)
    if plan is not None:
        vals, patches = plan
        out = block_fill(to_device(vals.reshape(-1), dev))
        for dst, op, rel, n in patches:
            if op.kind == "copy":
                out[dst:dst + n] = comp[op.src + rel:op.src + rel + n]
            else:
                out[dst:dst + n] = _pattern(op.pattern, rel, n, dev)
        return out

    if all(op.kind != "self" for op in ops):
        # segments tile the output in order, with no holes
        return torch.cat([
            comp[op.src:op.src + op.n] if op.kind == "copy"
            else _pattern(op.pattern, 0, op.n, dev)
            for op in ops
        ])

    out = torch.zeros(max(n_out, 1), dtype=torch.uint8, device=dev)
    for op in ops:
        if op.kind == "copy":
            out[op.dst:op.dst + op.n] = comp[op.src:op.src + op.n]
        elif op.kind == "fill":
            out[op.dst:op.dst + op.n] = _pattern(op.pattern, 0, op.n, dev)
        else:   # 'self': source ends at or before dst (offset-sized chunks)
            out[op.dst:op.dst + op.n] = out[op.src:op.src + op.n]
    return out


def decode_sparse(program: SparseProgram, buf: np.ndarray,
                  device="cpu") -> bytes:
    out = decode_sparse_device(program, to_device(buf, device))
    return out[:program.n_out].cpu().numpy().tobytes()
