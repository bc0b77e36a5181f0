"""mxu2 engine: per-byte routing codes from the host packer (port of
``lz4tpu.device.mxu2``), for text chains that overflow the fused
engine's in-substep patch budget.

The native packer resolves every output byte's provenance on the host
(``DensePack2``: one int32 code per byte).  The device side is kernel
H3 (``csrc/mxu2.cu``): :func:`route` walks each chain's substeps in
order through the 64 KiB ring.  :func:`route_plain` is its plain
PyTorch version, taken only for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from . import native_engine, to_device, to_device_packed
from .ring import RING, part_segments, segments_array, zero_ring

SUB = 2048          # output bytes per substep
PAGES = 256         # 64 KiB history ring: 256 pages x 256 bytes
ROWB = 256          # bytes per ring row
PART_SUBS = 32768   # substeps per launch (64 MiB output, 256 MiB codes)


@dataclasses.dataclass
class DensePack2:
    """Per-byte routing codes for one or more chains; the fields of
    ``lz4tpu.device.mxu2.DensePack2``.

    code[i, j] describes output byte j of substep i:
      bit 16 set   -> ring byte: bits 0..15 = source position mod 64 Ki
      bit 16 clear -> known value: bits 17..24 = the byte
    """

    code: np.ndarray       # int32 [n_sub, SUB]
    scal: np.ndarray       # int32 [n_sub, 1]: ring row to write (mult of 8)
    n_sub: int
    out_spans: list        # [(chain_id, sub_lo, sub_hi, out_len)]


def pack_from_numpy(pack) -> DensePack2:
    """The port's DensePack2 from a ``lz4tpu.device.mxu2.DensePack2``."""
    return DensePack2(code=np.array(pack.code), scal=np.array(pack.scal),
                      n_sub=pack.n_sub, out_spans=list(pack.out_spans))


def pack_dense2(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    chain_ranges: list | None = None,
) -> DensePack2:
    """Pack sequence-table ranges (one per independent chain) into
    per-byte routing codes with the native resolver (JAX-free copy of
    ``lz4tpu.device.mxu2.pack_dense2``, native path only)."""
    native = native_engine()
    if chain_ranges is None:
        chain_ranges = [(0, lit_len.size)]
    ll = np.ascontiguousarray(lit_len, np.int32)
    ls = np.ascontiguousarray(lit_src, np.int32)
    ml = np.ascontiguousarray(match_len, np.int32)
    mo = np.ascontiguousarray(match_off, np.int32)
    sizes64 = ll.astype(np.int64) + ml
    chain_outs = [int(sizes64[lo:hi].sum()) for lo, hi in chain_ranges]
    chain_subs = [-(-n // SUB) if n else 0 for n in chain_outs]
    total_subs = sum(chain_subs)
    if total_subs == 0:
        return DensePack2(
            code=np.zeros((0, SUB), np.int32),
            scal=np.zeros((0, 1), np.int32),
            n_sub=0,
            out_spans=[(c, 0, 0, 0) for c in range(len(chain_ranges))],
        )
    # one padded (n_sub, SUB) array; the resolver wild-writes up to 16
    # words past a chain's end and re-zeroes them
    flat = np.zeros(total_subs * SUB + 16, np.int32)
    scal = np.empty((total_subs, 1), np.int32)
    out_spans = []
    sub_base = 0
    for c, (lo, hi) in enumerate(chain_ranges):
        n_out = chain_outs[c]
        if n_out == 0:
            out_spans.append((c, sub_base, sub_base, 0))
            continue
        native.pack_dense2_chain(
            buf, ll[lo:hi], ls[lo:hi], ml[lo:hi], mo[lo:hi],
            out=flat[sub_base * SUB:],
        )
        n_sub_c = chain_subs[c]
        scal[sub_base:sub_base + n_sub_c, 0] = (
            (np.arange(n_sub_c, dtype=np.int32) * (SUB // ROWB))
            & (PAGES - 1)
        )
        out_spans.append((c, sub_base, sub_base + n_sub_c, n_out))
        sub_base += n_sub_c
    return DensePack2(
        code=flat[:total_subs * SUB].reshape(total_subs, SUB),
        scal=scal, n_sub=total_subs, out_spans=out_spans,
    )


def route(code: torch.Tensor, scal: torch.Tensor, segs: torch.Tensor,
          ring_in: torch.Tensor | None = None):
    """Decode every segment ``segs[k] = (lo, hi, carry)`` of substeps in
    order through its ring; returns ``(rows, ring_out)``: uint8
    ``(n_sub * SUB,)`` and the last segment's final ``(65536,)`` ring."""
    if code.device.type == "cpu":
        return route_plain(code, scal, segs, ring_in)
    n = code.shape[0]
    dev = code.device
    _kernels.check(code, "code", torch.int32, (n, SUB))
    _kernels.check(scal, "scal", torch.int32, (n, 1), align=4)
    _kernels.check(segs, "segs", torch.int32, (segs.shape[0], 3), align=4)
    if ring_in is not None:
        _kernels.check(ring_in, "ring_in", torch.uint8, (RING,))
    rows = torch.empty(n * SUB, dtype=torch.uint8, device=dev)
    ring_out = torch.empty(RING, dtype=torch.uint8, device=dev)
    _kernels.launch(
        "mxu2_route", "lz4t_mxu2_route", dev,
        code.data_ptr(), scal.data_ptr(), segs.data_ptr(), segs.shape[0],
        _kernels.ptr(ring_in), rows.data_ptr(), ring_out.data_ptr())
    return rows, ring_out


def route_plain(code: torch.Tensor, scal: torch.Tensor, segs: torch.Tensor,
                ring_in: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`route`: a serial substep loop."""
    dev = code.device
    n = code.shape[0]
    rows = torch.zeros(n * SUB, dtype=torch.uint8, device=dev)
    is_ring = ((code >> 16) & 1).bool()
    src = (code & 0xFFFF).to(torch.int64)
    known = ((code >> 17) & 255).to(torch.uint8)
    ring_rows = scal[:, 0].tolist()
    ring = zero_ring(dev)
    for lo, hi, carry in segs.tolist():
        ring = (ring_in.clone() if carry and ring_in is not None
                else zero_ring(dev))
        for i in range(lo, hi):
            vals = torch.where(is_ring[i], ring[src[i]], known[i])
            rows[i * SUB:(i + 1) * SUB] = vals
            r = (ring_rows[i] & 255) * ROWB
            ring[r:r + SUB] = vals
    return rows, ring


def decode_dense2_rows(pack: DensePack2, device, ring_in=None,
                       part_subs: int | None = None):
    """Decode a DensePack2 on ``device``; returns ``(rows, ring_out)``:
    flat uint8 rows ``(n_sub * SUB,)`` (chain ``k``'s bytes at
    ``out_spans[k]``) and the final ring.  Packs beyond ``part_subs``
    substeps launch part by part, each part's ring seeding the next;
    ``ring_in`` seeds the first chain's ring."""
    dev = torch.device(device)
    n = pack.n_sub
    if n == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                zero_ring(dev) if ring_in is None else ring_in)
    part = part_subs or PART_SUBS
    bounds = [(p0, min(p0 + part, n)) for p0 in range(0, n, part)]
    # the small tables share one staging copy
    scal, *part_segs = to_device_packed(
        [pack.scal[:n]]
        + [segments_array(part_segments(pack.out_spans, p0, p1,
                                        seeded=ring_in is not None))
           for p0, p1 in bounds], dev)
    ring = ring_in
    parts = []
    for (p0, p1), segs in zip(bounds, part_segs):
        rows, ring = route(to_device(pack.code[p0:p1], dev), scal[p0:p1],
                           segs, ring)
        parts.append(rows)
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), ring
