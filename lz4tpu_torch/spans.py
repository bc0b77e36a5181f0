"""Span-parallel decode of one dependent-block chain (port of
``lz4tpu.spans``).

Linked blocks decode in order through the 64 KiB history ring, so one
frame of linked blocks is one serial chain.  This module splits such a
chain into SPANS at substep (2048 B) boundaries, each a multiple of the
64 KiB ring, so that every span decodes through the fused engine
(kernel H1) on its own:

* **Span sequence columns**: the chain's sequence table restricted to a
  span's output range, the two boundary sequences clipped (a cut inside
  a literal run shortens it and advances ``lit_src``; a cut inside a
  match shortens the match and keeps its offset), in span-local
  coordinates, so the fused prep runs unchanged on them.
* **Boundary ring seeds**: a span's back-references reach up to 64 KiB
  before its start.  The host materialises those 64 KiB without
  decoding the stream: every output byte is a copy of some literal
  byte, so :func:`resolve_ring_bytes` follows each position's
  provenance through the sequence table (the native
  ``resolve_window``, with :func:`_resolve_ring_bytes_numpy` beside it
  as its differential reference) and gathers the literal bytes from the
  compressed buffer.  Host work is O(64 Ki x depth) a boundary.

The sharded decode (``lz4tpu_torch.dist``) schedules the spans of a
chain like independent chains, each span's ring seeded with its
boundary window (:func:`ring_seed_array`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import fused, to_device

SUB = fused.SUB
RING = 1 << 16            # history ring bytes (HISTORY_SIZE)
RING_SUBS = RING // SUB   # 32 substeps a ring window
# Provenance-walk budget: positions touched over all rounds of one
# resolve call.  Real data stays far below it; pathological inputs
# overflow and the caller does not split the chain.
_RESOLVE_WORK_MAX = 1 << 24


class SpanResolveOverflow(Exception):
    """The provenance walk exceeded its work budget; the chain is not
    split (callers decode it whole)."""


@dataclasses.dataclass
class ChainSpan:
    """One span of a chain, with SPAN-LOCAL sequence columns."""

    sub_lo: int           # first substep (chain-global)
    sub_hi: int           # one past the last substep (chain-global)
    out_lo: int           # chain-local output byte range
    out_hi: int
    ll: np.ndarray        # span-local sequence columns (int32)
    ml: np.ndarray
    mo: np.ndarray
    ls: np.ndarray        # global offsets into the compressed buffer


def plan_spans(n_out: int, n_parts: int,
               min_subs: int = 2 * RING_SUBS) -> list[tuple[int, int]]:
    """Split ``n_out`` chain bytes into up to ``n_parts`` substep ranges,
    every boundary a multiple of RING_SUBS (64 KiB) and no span shorter
    than ``min_subs`` substeps."""
    n_sub = -(-n_out // SUB) if n_out else 0
    if n_sub == 0 or n_parts <= 1:
        return [(0, n_sub)] if n_sub else []
    units = -(-n_sub // RING_SUBS)           # 64 KiB units (last partial)
    min_units = max(1, min_subs // RING_SUBS)
    parts = min(n_parts, units // min_units)
    if parts <= 1:
        return [(0, n_sub)]
    # sizes differ by at most one unit
    base, rem = divmod(units, parts)
    out = []
    lo_u = 0
    for k in range(parts):
        hi_u = lo_u + base + (1 if k < rem else 0)
        out.append((lo_u * RING_SUBS, min(hi_u * RING_SUBS, n_sub)))
        lo_u = hi_u
    return out


def _starts_ext(ll: np.ndarray, ml: np.ndarray) -> np.ndarray:
    """Chain-local exclusive prefix of sequence sizes with an end
    sentinel: ``starts_ext[s]`` is where sequence s begins,
    ``starts_ext[S]`` is n_out."""
    sizes = ll.astype(np.int64) + ml.astype(np.int64)
    starts = np.zeros(sizes.size + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    return starts


def split_chain_spans(
    ll: np.ndarray, ml: np.ndarray, mo: np.ndarray, ls: np.ndarray,
    ranges: list[tuple[int, int]],
    starts: np.ndarray | None = None,
) -> list[ChainSpan]:
    """Span-local sequence columns for each substep range.  With
    sequence s covering literals ``[st, st+l)`` then match bytes
    ``[st+l, st+l+m)``, the span ``[B0, B1)`` keeps

        ll' = max(0, min(st+l, B1) - max(st, B0))
        ls' = ls + max(B0 - st, 0)
        ml' = max(0, min(st+l+m, B1) - max(st+l, B0))

    A match clipped at its head keeps its offset: its kept bytes' sources
    move before B0, into the span's ring seed."""
    if starts is None:
        starts = _starts_ext(ll, ml)
    S = ll.size
    spans = []
    for (slo_sub, shi_sub) in ranges:
        B0 = slo_sub * SUB
        B1 = min(shi_sub * SUB, int(starts[S]))
        s_lo = max(int(np.searchsorted(starts, B0, side="right")) - 1, 0)
        s_hi = int(np.searchsorted(starts, B1, side="left"))  # exclusive
        st = starts[s_lo:s_hi]
        l_ = ll[s_lo:s_hi].astype(np.int64)
        m_ = ml[s_lo:s_hi].astype(np.int64)
        lit_end = st + l_
        ll2 = np.clip(np.minimum(lit_end, B1) - np.maximum(st, B0),
                      0, None)
        ml2 = np.clip(np.minimum(lit_end + m_, B1)
                      - np.maximum(lit_end, B0), 0, None)
        ls2 = ls[s_lo:s_hi].astype(np.int64) + np.maximum(B0 - st, 0)
        mo2 = np.maximum(mo[s_lo:s_hi].astype(np.int64), 1)
        total = int(ll2.sum() + ml2.sum())
        if total != B1 - B0:
            raise AssertionError(
                f"span clip mismatch: {total} != {B1 - B0}"
            )
        spans.append(ChainSpan(
            sub_lo=slo_sub, sub_hi=shi_sub, out_lo=B0, out_hi=B1,
            ll=ll2.astype(np.int32), ml=ml2.astype(np.int32),
            mo=mo2.astype(np.int32), ls=ls2.astype(np.int32),
        ))
    return spans


def resolve_ring_bytes(
    ll: np.ndarray, ml: np.ndarray, mo: np.ndarray, ls: np.ndarray,
    buf: np.ndarray, boundary: int, nbytes: int = RING,
    starts: np.ndarray | None = None,
    work_max: int = _RESOLVE_WORK_MAX,
) -> np.ndarray:
    """Chain output bytes ``[boundary - nbytes, boundary)`` through the
    native resolver (``native.resolve_window``: an ascending in-window
    memo and run-amortised chain walks), or, where the native engine is
    absent, :func:`_resolve_ring_bytes_numpy`, which computes the same
    bytes and is its differential reference.  Either raises
    SpanResolveOverflow on a walk past ``work_max``."""
    from . import native

    if starts is None:
        starts = _starts_ext(ll, ml)
    if not native.available():
        return _resolve_ring_bytes_numpy(
            ll, ml, mo, ls, buf, boundary, nbytes, starts, work_max)
    try:
        return native.resolve_window(
            np.ascontiguousarray(ll, np.int32),
            np.ascontiguousarray(ml, np.int32),
            np.ascontiguousarray(mo, np.int32),
            np.ascontiguousarray(ls, np.int32),
            np.ascontiguousarray(buf, np.uint8),
            np.ascontiguousarray(starts, np.int32),
            boundary, nbytes, hop_budget=work_max,
        )
    except ValueError as exc:
        raise SpanResolveOverflow(str(exc)) from None


def _resolve_ring_bytes_numpy(
    ll: np.ndarray, ml: np.ndarray, mo: np.ndarray, ls: np.ndarray,
    buf: np.ndarray, boundary: int, nbytes: int = RING,
    starts: np.ndarray | None = None,
    work_max: int = _RESOLVE_WORK_MAX,
) -> np.ndarray:
    """Chain output bytes ``[boundary - nbytes, boundary)`` by
    provenance chain-following in numpy rounds, with no sequential
    decode.

    Descent: each round maps every unresolved position to its sequence;
    literal positions resolve at once (``buf[lit_src + local]``); match
    positions hop to their source, positions of an overlapping match
    collapse in one hop to ``m0 - off + (p - m0) mod off``, then
    deduplicate.  Every hop lowers the position, so the walk ends; the
    work cap bounds adversarial inputs.  Ascent: resolved values go back
    through each round's dedup index.

    Returns uint8[nbytes]; positions before the chain start are zero
    (never referenced: the token scan checks back-references against
    the frame start)."""
    if starts is None:
        starts = _starts_ext(ll, ml)
    out = np.zeros(nbytes, np.uint8)
    lo = max(boundary - nbytes, 0)
    if lo >= boundary:
        return out
    pos = np.arange(lo, boundary, dtype=np.int64)
    base_slot = nbytes - (boundary - lo)

    ll64 = ll.astype(np.int64)
    rounds = []   # (values, lit_mask, match index, dedup inverse)
    work = 0
    while pos.size:
        work += pos.size
        if work > work_max:
            raise SpanResolveOverflow(work)
        s = np.searchsorted(starts, pos, side="right") - 1
        np.maximum(s, 0, out=s)
        local = pos - starts[s]
        is_lit = local < ll64[s]
        vals = np.zeros(pos.size, np.uint8)
        if is_lit.any():
            li = np.where(is_lit)[0]
            vals[li] = buf[ls[s[li]].astype(np.int64) + local[li]]
        mi = np.where(~is_lit)[0]
        if mi.size == 0:
            rounds.append((vals, is_lit, None, None))
            break
        sm = s[mi]
        off = np.maximum(mo[sm].astype(np.int64), 1)
        m0 = starts[sm] + ll64[sm]
        p = pos[mi]
        hop = p - off
        deep = hop >= m0
        if deep.any():
            hop = np.where(deep, m0 - off + (p - m0) % off, hop)
        uniq, inv = np.unique(hop, return_inverse=True)
        rounds.append((vals, is_lit, mi, inv))
        pos = uniq

    prev_vals = None
    for (vals, _is_lit, mi, inv) in reversed(rounds):
        if mi is not None:
            vals[mi] = prev_vals[inv]
        prev_vals = vals
    out[base_slot:] = prev_vals
    return out


def ring_seed_array(ring_bytes: np.ndarray, boundary: int,
                    device="cuda") -> torch.Tensor:
    """Boundary bytes as kernel H1's ``ring_in``: a ``(RING,)`` uint8
    tensor on ``device`` whose index ``q mod RING`` holds chain output
    byte q, for q in ``[boundary - RING, boundary)``.

    ``ring_bytes`` is :func:`resolve_ring_bytes`' window ending at
    ``boundary``.  The JAX package's version takes ``rpages`` and lays
    the bytes out as bf16 pages of a ring cut to the chain's largest
    offset; the port's route always keeps the full 64 KiB ring, so there
    is no ``rpages``.  :func:`plan_spans` puts every boundary on a
    multiple of RING, where this layout is the window in order, and
    chain-global and span-local positions agree mod RING: one layout
    serves both the chain-coordinate slices (:func:`slice_prep`) and
    the span-local preps (:func:`split_chain_spans`)."""
    tail = np.asarray(ring_bytes[-RING:], np.uint8)
    return to_device(np.roll(tail, boundary % RING), device)


def prep_span(span: ChainSpan, buf: np.ndarray,
              pooled: bool = True) -> fused.FusedPrep:
    """Fused prep of one span in span-local coordinates (a span preps
    like a chain; only its ring is seeded at decode time).
    ``pooled=False`` for callers that keep several span preps alive at
    once (the prep buffer pool recycles after a few preps)."""
    return fused.prep_fused(span.ll, span.ml, span.mo, span.ls, buf,
                            pooled=pooled)


def split_fused_chain(table, chain, buf: np.ndarray, n_parts: int,
                      with_rings: bool = True):
    """Spans, span-local preps and boundary ring windows of one chain of
    a ``pipeline.SeqTable``: ``(spans, preps, rings)`` with ``rings[k]``
    the uint8[RING] window ending at span k (``rings[0]`` is None: empty
    history), or ``rings=None`` for ``with_rings=False``; None when the
    chain does not split.  Raises ``fused.FusedOverflow`` or
    SpanResolveOverflow when it cannot split."""
    sl = slice(chain.seq_lo, chain.seq_hi)
    ll = table.lit_len[sl]
    ml = table.match_len[sl]
    mo = table.match_off[sl]
    ls = table.lit_src[sl]
    ranges = plan_spans(chain.out_hi - chain.out_lo, n_parts)
    if len(ranges) <= 1:
        return None
    starts = _starts_ext(ll, ml)
    spans = split_chain_spans(ll, ml, mo, ls, ranges, starts)
    # pooled=False: every span prep stays alive at once
    preps = [prep_span(s, buf, pooled=False) for s in spans]
    rings = None
    if with_rings:
        rings = [None] + resolve_rings(
            ll, ml, mo, ls, buf, [s.out_lo for s in spans[1:]], starts
        )
    return spans, preps, rings


def resolve_rings(ll, ml, mo, ls, buf, boundaries: list[int],
                  starts: np.ndarray | None = None) -> list[np.ndarray]:
    """Boundary windows of several boundaries, resolved on a thread pool
    (the native walk releases the interpreter lock; each boundary costs
    the same whatever the span's length); on one thread without the
    native engine (the numpy walk holds the lock)."""
    from . import native

    if starts is None:
        starts = _starts_ext(ll, ml)
    threads = native.pack_threads() if native.available() else 1
    if len(boundaries) > 1 and threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(threads, len(boundaries))
        ) as ex:
            return list(ex.map(
                lambda b: resolve_ring_bytes(
                    ll, ml, mo, ls, buf, b, RING, starts),
                boundaries,
            ))
    return [resolve_ring_bytes(ll, ml, mo, ls, buf, b, RING, starts)
            for b in boundaries]


def slice_prep(prep: fused.FusedPrep, sub_lo: int, sub_hi: int,
               out_len: int) -> fused.FusedPrep:
    """Substeps ``[sub_lo, sub_hi)`` of a whole-chain fused prep, in
    CHAIN coordinates (the sharded decode's span units: one prep a
    chain, sliced per unit):

    * records and patches are per substep, so a slice of a prep that fit
      every budget fits them too;
    * the per-substep scalars (the u0/v0/b0 carries, ring row, window
      offset) are chain-global, so a slice's first substep describes
      itself, mid-sequence included: a sequence that straddles the cut
      contributes through the carries, its record in the earlier slice;
    * ring positions stay chain positions mod RING, the layout of
      :func:`ring_seed_array`.

    Every slice shares the whole ``lits`` array; ``n_seq_recs`` and
    ``n_patches`` are the whole prep's.  The JAX kernel reloads its
    literal window at a slice's first grid step whatever the reload
    flag says; the port's route reads its window through ``winq`` for
    every substep, so a slice that begins mid-window needs nothing
    more."""
    return fused.FusedPrep(
        seqrec=prep.seqrec[sub_lo:sub_hi],
        lits=prep.lits,
        winq=prep.winq[sub_lo:sub_hi],
        scal=prep.scal[sub_lo:sub_hi],
        patch=prep.patch[sub_lo:sub_hi],
        n_sub=sub_hi - sub_lo,
        n_patches=prep.n_patches,
        n_seq_recs=prep.n_seq_recs,
        out_spans=[(0, 0, sub_hi - sub_lo, out_len)],
        max_off=prep.max_off,
        max_recs=prep.max_recs,
        max_patches=prep.max_patches,
    )


def decode_span_on_device(prep: fused.FusedPrep, ring_bytes, boundary,
                          device="cuda") -> torch.Tensor:
    """Decode one host-seeded span on ``device``; returns its flat uint8
    rows ``(n_sub * SUB,)``.  ``ring_bytes=None`` means empty history
    (span 0): its segment starts from a zero ring, the others from the
    seed."""
    from .pipeline import _resolve_device

    dev = _resolve_device(device)
    ring = (None if ring_bytes is None
            else ring_seed_array(ring_bytes, boundary, dev))
    rows, _ring = fused.decode_fused_rows(prep, dev, ring_in=ring)
    return rows
