"""Sparse-chain decoder (port of ``lz4tpu.device.sparse_decode``).

Zeros/RLE and incompressible chains spend their bytes in a few giant
segments; the host builds a small program of copy / fill / self ops
(:func:`build_sparse_program`, the JAX package's builder copied without
JAX).  The program runs as PyTorch slicing on the staged compressed
tensor — data movement, as XLA ran it in the JAX package — except the
fill of whole 512 KiB blocks, which is kernel H2 (``csrc/block_fill.cu``)
behind :func:`block_fill`, with :func:`block_fill_plain` as its plain
PyTorch version for CPU tensors.
"""

from __future__ import annotations

import bisect
import dataclasses
import typing

import numpy as np
import torch

from .. import _kernels
from . import to_device

FILL_BLK = 1 << 19      # block-fill block (512 KiB)
MAX_PATTERN = 64        # resolve fill patterns up to this offset
MAX_SELF_CHUNKS = 32    # split budget for self-overlapping big matches
MAX_OPS = 512           # program-size cap: beyond this, not "sparse"


class SparseOp(typing.NamedTuple):
    # NamedTuple, not a frozen dataclass: program builds construct one
    # op per segment and object.__setattr__-based init was the largest
    # term in copy-heavy plans (b3444k: 54 ops)
    kind: str            # 'copy' | 'fill' | 'self'
    dst: int
    n: int
    src: int = 0         # comp offset ('copy') / out offset ('self')
    pattern: bytes = b""  # 'fill' only


@dataclasses.dataclass
class SparseProgram:
    ops: tuple           # tuple[SparseOp, ...]
    n_out: int


class _Unsupported(Exception):
    pass


class _Builder:
    def __init__(self, buf: np.ndarray):
        self.buf = buf
        self.ops: list = []
        self._dsts: list = []   # ops are contiguous, sorted by dst
        self.pos = 0

    def _byte_at(self, p: int, depth: int = 0) -> int:
        """Resolve the decoded byte at output position p from segment
        metadata (host side, no decoding)."""
        if depth > 16:
            raise _Unsupported("pattern chain too deep")
        # ops partition [0, pos) in dst order: bisect for the owner
        # (the old linear reversed-scan was O(ops) per pattern byte —
        # 0.17 ms of the b3444k plan)
        i = bisect.bisect_right(self._dsts, p) - 1
        if i >= 0:
            op = self.ops[i]
            if op.dst <= p < op.dst + op.n:
                rel = p - op.dst
                if op.kind == "copy":
                    return int(self.buf[op.src + rel])
                if op.kind == "fill":
                    return op.pattern[rel % len(op.pattern)]
                return self._byte_at(op.src + rel, depth + 1)
        raise _Unsupported("byte before chain start")

    def _push(self, op: SparseOp):
        if len(self.ops) >= MAX_OPS:
            raise _Unsupported("too many segments for the sparse path")
        self.ops.append(op)
        self._dsts.append(op.dst)
        self.pos += op.n

    def literal(self, comp_off: int, n: int):
        if n:
            self._push(SparseOp("copy", self.pos, n, src=int(comp_off)))

    def match(self, off: int, n: int):
        if n == 0:
            return
        if off <= MAX_PATTERN:
            pattern = bytes(
                self._byte_at(self.pos - off + k) for k in range(off)
            )
            self._push(SparseOp("fill", self.pos, n, pattern=pattern))
            return
        if n <= off:
            self._push(SparseOp("self", self.pos, n, src=self.pos - off))
            return
        # self-overlapping large-offset match: offset-sized chunks
        if (n + off - 1) // off > MAX_SELF_CHUNKS:
            raise _Unsupported("overlapping match needs too many chunks")
        rem = n
        while rem > 0:
            take = min(rem, off)
            self._push(SparseOp("self", self.pos, take, src=self.pos - off))
            rem -= take


def build_sparse_program(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
) -> SparseProgram | None:
    """Try to express one chain as a sparse program; None if it isn't
    sparse-shaped (the caller falls back to another engine)."""
    b = _Builder(buf)
    try:
        # one bulk tolist() per array: per-element numpy-scalar
        # conversion dominates this Python loop for copy-heavy chains
        for ls, ll, mo, ml in zip(lit_src.tolist(), lit_len.tolist(),
                                  match_off.tolist(), match_len.tolist()):
            b.literal(ls, ll)
            b.match(mo if mo > 1 else 1, ml)
    except _Unsupported:
        return None
    return SparseProgram(ops=tuple(b.ops), n_out=b.pos)


def _plan_block_fill(ops: tuple, n_out: int):
    """Uniform-fill block plan: per-512KiB-block byte values plus small
    patch segments for everything else.  Returns (vals, patches) or
    None when the program isn't fill-dominated.

    Rationale: zeros-like vectors (z9m) are one giant memset, which
    the block-fill kernel writes at device-memory bandwidth.
    """
    n_b = -(-n_out // FILL_BLK)
    vals = np.zeros(n_b, np.int32)
    covered = np.zeros(n_b, bool)
    uniform = [op.kind == "fill" and len(set(op.pattern)) == 1
               for op in ops]
    if any(op.kind == "self" for op in ops):
        return None

    # Pass 1 — block ownership.  A uniform fill owns every block it
    # fully covers, and CLAIMS a partial head/tail block when its
    # share of that block is the largest among uniform fills (e.g.
    # z9m: [copy 1 B | fill 9.4 MB | copy 5 B] — the fill starts 1
    # byte in, so block 0 is 512Ki-1/512Ki fill; claiming it leaves a
    # 1-byte patch instead of a 512 KiB one).
    best_share: dict = {}       # partial block -> (share, op index)
    for k, op in enumerate(ops):
        if not uniform[k]:
            continue
        b_lo = -(-op.dst // FILL_BLK)
        b_hi = (op.dst + op.n) // FILL_BLK
        if b_hi > b_lo:
            vals[b_lo:b_hi] = op.pattern[0]
            covered[b_lo:b_hi] = True
        b0 = op.dst // FILL_BLK
        b1 = (op.dst + op.n - 1) // FILL_BLK
        for b in {b0, b1}:
            lo = max(op.dst, b * FILL_BLK)
            hi = min(op.dst + op.n, (b + 1) * FILL_BLK)
            if hi - lo in (0, FILL_BLK):
                continue            # empty or fully covered above
            if hi - lo > best_share.get(b, (0, -1))[0]:
                best_share[b] = (hi - lo, k)
    owner = {}
    for b, (share, k) in best_share.items():
        if not covered[b]:
            vals[b] = ops[k].pattern[0]
            covered[b] = True
            owner[b] = k

    # Pass 2 — patches: every byte not written by its block's fill.
    # Uniform-fill fragments are memsets (bandwidth-only), so only
    # NON-uniform
    # patch bytes count against the budget.
    patches: list = []          # (dst, op, rel_lo, n)
    patch_bytes = 0
    for k, op in enumerate(ops):
        if uniform[k]:
            b0 = op.dst // FILL_BLK
            b1 = (op.dst + op.n - 1) // FILL_BLK
            for b in sorted({b0, b1}):
                lo = max(op.dst, b * FILL_BLK)
                hi = min(op.dst + op.n, (b + 1) * FILL_BLK)
                if hi - lo in (0, FILL_BLK) or owner.get(b) == k:
                    continue
                patches.append((lo, op, lo - op.dst, hi - lo))
        else:
            patches.append((op.dst, op, 0, op.n))
            patch_bytes += op.n
    if patch_bytes > max(1 << 16, n_out >> 6) or len(patches) > 1024:
        return None
    if not covered.any():
        # nothing to block-fill: the hole-free concat path is cheaper
        return None
    # uncovered blocks are fully patched (ops tile [0, n) contiguously)
    return vals.reshape(-1, 1), tuple(patches)



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
                  device="cuda") -> bytes:
    """Run ``program`` over ``buf`` on ``device`` and return the bytes.
    The default ``"cuda"`` raises where CUDA is absent; ``"cpu"`` takes
    the plain path."""
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    out = decode_sparse_device(program, to_device(buf, dev))
    return out[:program.n_out].cpu().numpy().tobytes()
