"""Byte-parallel LZ4 decode on the device (port of
``lz4tpu.device.decode``).

A data-parallel formulation of the reference's sequential
pointer-chasing loop (reference: lib/lz4ada.adb:716-904), as plain
tensor operations (the JAX package computes it outside any kernel too):

1. **Sequence table** (host, native token scan): per-sequence records
   (literal length/source, match offset); output offsets follow from a
   prefix sum.
2. **Ownership map**: each output byte finds its sequence with a
   scatter + running max.
3. **Source resolution**: each output byte's provenance is either a
   literal byte in the compressed input, or ``out[i - offset]``.
   Self-overlapping matches are collapsed with a modulo so every match
   byte points strictly before its own match start.  Remaining chains
   are resolved by pointer doubling, ``src = src[src]``: log2(depth)
   gathers instead of a sequential walk.
4. **Byte gather**: one final gather pulls every output byte from the
   compressed input's literal regions.

Encoding convention: values < 0 are resolved literal pointers
(``-(comp_index) - 1``); values >= 0 are unresolved output positions.

This engine is the correctness fallback, never the fast path.  The
doubling runs ``doubling_iters`` rounds and returns an ``unresolved``
flag; :func:`resolve_sources` re-invokes for deeper chains, so
convergence is checked, not assumed (one host synchronisation per
round of up to ``UNROLL_ITERS`` doublings).  ``torch`` indexes with
int64, so the gathers hold 8 bytes per output byte beside the int32
maps.
"""

from __future__ import annotations

import torch

UNROLL_ITERS = 16


def _double(src: torch.Tensor, n_out: int) -> torch.Tensor:
    hop = src[src.clamp(0, n_out - 1).long()]
    return torch.where(src >= 0, hop, src)


def build_sources(
    out_start: torch.Tensor,   # int32 [S] output offset per sequence
    lit_len: torch.Tensor,     # int32 [S]
    lit_src: torch.Tensor,     # int32 [S] input offset of the literals
    match_off: torch.Tensor,   # int32 [S] back-reference distance
    produces: torch.Tensor,    # bool  [S] sequence emits at least one byte
    n_real: int,               # actual output size (<= n_out)
    n_out: int,
    iters: int = UNROLL_ITERS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial per-byte source map + doubling; returns (src,
    unresolved)."""
    dev = out_start.device
    s_ids = torch.arange(out_start.shape[0], dtype=torch.int32, device=dev)
    pos = torch.arange(n_out, dtype=torch.int32, device=dev)

    # Ownership: seq_id[i] = index of the sequence producing byte i.
    # Sequences that produce nothing claim the spill slot n_out.
    claims = torch.zeros(n_out + 1, dtype=torch.int32, device=dev)
    at = torch.where(produces, out_start,
                     torch.full_like(out_start, n_out)).clamp(0, n_out)
    claims.scatter_reduce_(0, at.long(), s_ids, "amax")
    seq_id = torch.cummax(claims[:n_out], 0).values.long()

    os_ = out_start[seq_id]
    ll = lit_len[seq_id]
    ls = lit_src[seq_id]
    mo = match_off[seq_id].clamp(min=1)    # 0 on a block's last sequence

    local = pos - os_
    mstart = os_ + ll
    lit_ptr = -(ls + local) - 1
    # fmod truncates toward zero like the JAX package's rem; the operand
    # is negative on literal bytes, whose lane `where` discards
    match_ptr = mstart - mo + torch.fmod(pos - mstart, mo)
    src = torch.where(local < ll, lit_ptr, match_ptr)
    # Padded tail resolves immediately (points at comp[0], sliced away).
    src = torch.where(pos < n_real, src, torch.full_like(src, -1))

    for _ in range(iters):
        src = _double(src, n_out)
    return src, (src >= 0).any()


def continue_doubling(src: torch.Tensor,
                      n_out: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Extra doubling rounds for chains deeper than 2**UNROLL_ITERS."""
    for _ in range(UNROLL_ITERS):
        src = _double(src, n_out)
    return src, (src >= 0).any()


def gather_bytes(comp: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Final byte gather: literal pointers -> decoded bytes."""
    return comp[(-src - 1).clamp(0, comp.shape[0] - 1).long()]


def doubling_iters(n_seqs: int) -> int:
    """Doubling rounds: chain depth is bounded by the sequence count
    (every hop lands in a strictly earlier sequence), so
    ceil(log2(S)) + 1 rounds always suffice; capped at UNROLL_ITERS
    (gathers are the dominant cost: do not run 16 rounds when 3
    resolve everything)."""
    iters = 1
    while (1 << iters) < max(2, n_seqs) and iters < UNROLL_ITERS:
        iters += 1
    return min(UNROLL_ITERS, iters + 1)


def resolve_sources(
    comp: torch.Tensor,
    out_start: torch.Tensor,
    lit_len: torch.Tensor,
    lit_src: torch.Tensor,
    match_off: torch.Tensor,
    produces: torch.Tensor,
    n_real: int,
    n_out: int,
    n_seqs: int | None = None,
) -> torch.Tensor:
    """Full device decode; returns the decoded bytes as a uint8
    ``(n_out,)`` tensor on ``comp``'s device.

    The convergence flag is read on the host after each round (one
    synchronisation), so the (rare) continue-doubling path costs an
    extra round trip.
    """
    if n_seqs is None:
        n_seqs = out_start.shape[0]
    if n_out == 0:
        return torch.zeros(0, dtype=torch.uint8, device=comp.device)
    src, unresolved = build_sources(
        out_start, lit_len, lit_src, match_off, produces,
        n_real, n_out, iters=doubling_iters(n_seqs),
    )
    while bool(unresolved):
        src, unresolved = continue_doubling(src, n_out)
    return gather_bytes(comp, src)
