"""Batched decode into a device tensor (port of ``lz4tpu.pipeline``'s
``decompress_to_device`` path).

The host layer is the JAX package's, imported: frame parse, native
token scan (``build_seq_table``), chain grouping (``_chains_of``) and
checksum verification (``_verify_checksums``).  The classifier
(:func:`plan_decode`) is a copy that plans with the port's JAX-free
fused prep and mxu2 packer; each chain then runs on one engine:

* sparse program (zeros/RLE, stored/incompressible) — torch slicing
  plus the block-fill kernel;
* fused kernel (text within the fused budgets);
* mxu2 kernel (text that overflows the fused patch budget).

``device="cpu"`` runs every engine's plain PyTorch version.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lz4tpu.constants import FOR_ALL, Reservation
from lz4tpu.errors import Lz4Error
from lz4tpu.frame import parse_frames
from lz4tpu.pipeline import (  # noqa: F401  (SeqTable, DecodeStats re-exported)
    _DENSE_MAX_CHAIN_OUT,
    _FUSED_MAX_CHAIN_OUT,
    _SPARSE_MAX_SEQS,
    BatchCapacityExceeded,
    DecodePlan,
    DecodeStats,
    SeqTable,
    _chains_of,
    _verify_checksums,
    build_seq_table,
)

from .device import fused as fu
from .device import mxu2 as mx
from .device import sparse_decode as sp
from .device import to_device


def plan_decode(buf: np.ndarray, parsed, table: SeqTable,
                stats: DecodeStats | None = None) -> DecodePlan:
    """Classify every chain and prepare the fused / mxu2 inputs: the
    plan of ``lz4tpu.pipeline.plan_decode`` with its default engine
    (same engines per chain, same per-chain FusedOverflow isolation).
    Chains over ``_DENSE_MAX_CHAIN_OUT`` go to ``plan.other`` (the
    resolver)."""
    plan = DecodePlan(sparse=[], dense_chains=[], dense_pack=None, other=[])
    dense_cand = []
    dense_ranges = []
    for chain in _chains_of(table):
        if chain.out_hi == chain.out_lo:
            continue
        sl = slice(chain.seq_lo, chain.seq_hi)
        n_seqs = chain.seq_hi - chain.seq_lo
        n_out_c = chain.out_hi - chain.out_lo
        if stats is not None:
            stats.n_chains += 1
        if n_seqs <= _SPARSE_MAX_SEQS:
            prog = sp.build_sparse_program(
                table.lit_len[sl], table.match_len[sl],
                table.match_off[sl], table.lit_src[sl], buf,
            )
            if prog is not None:
                plan.sparse.append((chain, prog))
                if stats is not None:
                    stats.note_engine("sparse", chain)
                continue
        if n_out_c > _DENSE_MAX_CHAIN_OUT:
            plan.other.append(chain)
            if stats is not None:
                stats.note_engine("resolve", chain)
            continue
        dense_cand.append(chain)
    fused_cand = [c for c in dense_cand
                  if c.out_hi - c.out_lo <= _FUSED_MAX_CHAIN_OUT]
    dense_cand = [c for c in dense_cand if c not in fused_cand]
    if fused_cand:

        def _try(chs):
            ranges = [(c.seq_lo, c.seq_hi) for c in chs]
            plan.fused_prep = fu.prep_fused(
                table.lit_len, table.match_len, table.match_off,
                table.lit_src, buf, chain_ranges=ranges,
                pre=(table.pre
                     if ranges == [(0, table.lit_len.size)] else None),
            )
            plan.fused_chains = chs

        try:
            _try(fused_cand)
            fused_cand = []
        except fu.FusedOverflow:
            if len(fused_cand) > 1:
                # budget overflows are a per-chain property (patch
                # density, window pressure): isolate the offenders
                ok = []
                for c in fused_cand:
                    try:
                        fu.prep_fused(
                            table.lit_len, table.match_len,
                            table.match_off, table.lit_src, buf,
                            chain_ranges=[(c.seq_lo, c.seq_hi)],
                        )
                        ok.append(c)
                    except fu.FusedOverflow:
                        continue
                if ok:
                    _try(ok)
                    fused_cand = [c for c in fused_cand if c not in ok]
    dense_cand = dense_cand + fused_cand
    for chain in plan.fused_chains:
        if stats is not None:
            stats.note_engine("fused", chain)
    for chain in dense_cand:
        plan.dense_chains.append(chain)
        dense_ranges.append((chain.seq_lo, chain.seq_hi))
        if stats is not None:
            stats.note_engine("dense", chain)
    if dense_ranges:
        plan.dense_pack = mx.pack_dense2(
            table.lit_len, table.match_len, table.match_off,
            table.lit_src, buf, chain_ranges=dense_ranges,
        )
    return plan


def build_device_segments(buf: np.ndarray, table: SeqTable,
                          plan: DecodePlan, device,
                          comp_dev: torch.Tensor | None = None) -> list:
    """Execute a DecodePlan on ``device``: ``[(out_lo, uint8 tensor of
    exactly the chain's length)]``.  ``comp_dev``: the compressed
    buffer already staged on ``device``, reused by sparse programs."""
    if plan.other:
        raise NotImplementedError(
            "lz4tpu_torch: chains over 1 GiB go to the byte-parallel "
            "resolver (lz4tpu/device/decode.py), which is not ported yet")
    dev = torch.device(device)
    segs: list = []
    if plan.sparse:
        if comp_dev is None:
            comp_dev = to_device(buf, dev)
        for chain, prog in plan.sparse:
            n_c = chain.out_hi - chain.out_lo
            segs.append(
                (chain.out_lo, sp.decode_sparse_device(prog, comp_dev)[:n_c])
            )
    for rows_of, prep, chains, sub in (
        (mx.decode_dense2_rows, plan.dense_pack, plan.dense_chains, mx.SUB),
        (fu.decode_fused_rows, plan.fused_prep, plan.fused_chains, fu.SUB),
    ):
        if prep is None:
            continue
        flat, _ring = rows_of(prep, dev)
        for chain, (_c, slo, _shi, out_len) in zip(chains, prep.out_spans):
            segs.append((chain.out_lo, flat[slo * sub: slo * sub + out_len]))
    return segs


def assemble_device_segments(segs: list, n_out: int, device) -> torch.Tensor:
    """Assemble ``[(out_lo, uint8 tensor)]`` into one ``(n_out,)``
    tensor (a single covering segment is returned as is)."""
    if (len(segs) == 1 and segs[0][0] == 0
            and segs[0][1].shape[0] == n_out):
        return segs[0][1]
    out = torch.zeros(n_out, dtype=torch.uint8, device=device)
    for lo, arr in segs:
        out[lo:lo + arr.shape[0]] = arr
    return out


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lz4tpu_torch.decompress_to_device: device='cuda' but CUDA is "
            "not available; pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def decompress_to_device(
    data,
    reservation: Reservation = FOR_ALL,
    *,
    device="cuda",
    verify: str = "host",
    out: torch.Tensor | None = None,
    pipelined: bool | None = None,
) -> torch.Tensor:
    """Decode a whole buffer into a uint8 tensor on ``device``.

    The contract of ``lz4tpu.decompress_to_device``: exactly the decoded
    bytes, the same exceptions (class and message) for the same input.
    ``device`` is explicit: ``"cuda"`` (the default) runs the kernels
    and raises when CUDA is absent; ``"cpu"`` runs their plain PyTorch
    versions.

    verify: ``"host"`` copies the output to the host and checks block
    and content checksums there; ``"none"`` skips the checksums (frame
    structure and sequence grammar are still validated host-side);
    ``"device"`` is not ported yet.

    out: optional caller 1-D uint8 tensor on ``device``; the decoded
    bytes are copied in place into ``out[:n]`` (the rest is left as it
    was) and ``out`` is returned.  Raises ``ValueError`` if it is too
    small, not 1-D uint8, or on another device.

    pipelined: the overlapped host-prep/device decode
    (``pipelined=True`` or ``LZ4TPU_PIPELINE=1``) is not ported yet.
    """
    dev = _resolve_device(device)
    if verify == "device":
        raise NotImplementedError(
            "lz4tpu_torch: verify='device' needs the xxh32 kernels "
            "(lz4tpu/device/xxh32_pallas.py), which are not ported yet")
    if pipelined is None:
        pipelined = os.environ.get("LZ4TPU_PIPELINE", "0") == "1"
    if pipelined:
        raise NotImplementedError(
            "lz4tpu_torch: the pipelined fused decode "
            "(lz4tpu.device.fused.decode_fused_pipelined) is not ported "
            "yet; pass pipelined=False")
    try:
        res = _decompress_to_device_batch(data, reservation, dev, verify)
    except Lz4Error:
        # stream-order fault precedence: the streaming engine
        # re-derives the diagnostic; if it succeeds (batch-only
        # structural limitation) stage its bytes instead
        from lz4tpu.api import decompress_host

        res = to_device(
            np.frombuffer(decompress_host(data, reservation), np.uint8), dev)
    if out is None:
        return res
    return _write_into(res, out)


def _write_into(res: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    if out.dtype != torch.uint8 or out.ndim != 1:
        raise ValueError("out must be a 1-D uint8 device array")
    if out.device != res.device:
        raise ValueError(
            f"out is on {out.device}, the decode ran on {res.device}")
    if out.shape[0] < res.shape[0]:
        raise ValueError(
            f"out too small: {out.shape[0]} < {res.shape[0]} decoded "
            "bytes"
        )
    out[:res.shape[0]].copy_(res)
    return out


def _decompress_to_device_batch(data, reservation, dev: torch.device,
                                verify: str) -> torch.Tensor:
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if buf.size == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    parsed = parse_frames(buf, reservation)
    try:
        table = build_seq_table(buf, parsed, reservation, data,
                                pooled_cols=True)
    except BatchCapacityExceeded as e:
        raise ValueError(
            "decompress_to_device: stream decodes past 2**31-1 bytes, "
            "beyond the batched pipeline's int32 coordinates; split the "
            "input by frame or use the streaming host engine"
        ) from e
    if table.n_out == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    segs = build_device_segments(
        buf, table, plan_decode(buf, parsed, table), dev)
    out_dev = assemble_device_segments(segs, table.n_out, dev)
    if verify == "host":
        _verify_checksums(buf, parsed, out_dev.cpu().numpy(), table)
    return out_dev
