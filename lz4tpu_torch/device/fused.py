"""Fused decode engine for text-like chains (port of
``lz4tpu.device.fused``).

The host prep is the JAX package's, copied without JAX (that module
jits its launchers at import): the native engine turns sequence-table
ranges into per-substep records (``FusedPrep``), O(sequences) work.
The device side is kernel H1 (``csrc/fused.cu``) as two launches:

* :func:`expand` — every substep in parallel: records + patches ->
  each byte's 17-bit source ``pos17`` (ring position below 65536,
  literal-window position above);
* :func:`route` — each chain in order through the 64 KiB ring: pos17 +
  literal windows -> output bytes, ring carried in and out.

Each has a plain PyTorch version (:func:`expand_plain`,
:func:`route_plain`), the torch form of ``fused.golden_decode``; a
wrapper takes it only for CPU tensors and launches the kernel for CUDA
tensors.

:func:`decode_fused_rows` decodes a whole prep in one launch pair per
part; :func:`decode_fused_pipelined` cuts one chain into 64-substep
chunks and launches each as soon as its range prep is done, the ring
carried on the card from chunk to chunk.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .. import _kernels
from . import native_engine, to_device, to_device_packed
from .ring import (RING, part_segments, segments_array, segments_tensor,
                   zero_ring)

SUB = 2048                 # output bytes per substep
ROWB = 256                 # ring row bytes
RPAGES = 256               # 64 KiB ring pages
WPAGES = 16                # literal window pages (4 KiB)
SEQ_MAX = 576              # seq records per substep
PATCH_MAX = 256            # in-substep patch budget per substep
LITWIN_Q = 4096            # literal window stride (bytes; blocks 8 KiB)
TAG = 1 << 17              # patch marker above the 17-bit position space
U_BIAS = 65536 - SUB       # literal pos17 = j + U + U_BIAS
PART_SUBS = 8192           # substeps per launch (16 MiB output)


@dataclasses.dataclass
class FusedPrep:
    """Kernel inputs for one or more chains; the fields and layouts of
    ``lz4tpu.device.fused.FusedPrep`` (numpy arrays, host side).

    Pooled arrays are recycled after ``_POOL_DEPTH`` further preps of
    one size class: stage them (:func:`decode_fused_rows` copies them
    to the device) before preparing more, or pass ``pooled=False``."""

    seqrec: np.ndarray     # int32 (n_sub, 2, 8, SEQ_MAX//8) records
    lits: np.ndarray       # uint8 (n_win, 32, 256) overlapped windows
    winq: np.ndarray       # int32 [n_sub] literal window index
    scal: np.ndarray       # int32 [n_sub, 8]:
                           #   ring row, wo, wabs, U0, V0, B0, reload, 0
    patch: np.ndarray      # int32 [n_sub, 8, PATCH_MAX//8] records
    n_sub: int
    n_patches: int
    n_seq_recs: int
    out_spans: list        # [(chain_id, sub_lo, sub_hi, out_len)]
    max_off: int = 65535
    max_recs: int = SEQ_MAX
    max_patches: int = PATCH_MAX


class FusedOverflow(Exception):
    """Chain exceeds a fused-kernel budget; the planner sends it to the
    mxu2 engine instead."""


def prep_from_numpy(prep) -> FusedPrep:
    """The port's FusedPrep from a ``lz4tpu.device.fused.FusedPrep``
    (copies the arrays, so the JAX package's prep pool may recycle
    them)."""
    fields = {f.name: getattr(prep, f.name)
              for f in dataclasses.fields(FusedPrep)}
    for name in ("seqrec", "lits", "winq", "scal", "patch"):
        fields[name] = np.array(fields[name])
    fields["out_spans"] = list(fields["out_spans"])
    return FusedPrep(**fields)


# ---------------------------------------------------------------------------
# host prep: JAX-free copy of lz4tpu/device/fused.py:314-500 (native path)
# ---------------------------------------------------------------------------

def prep_fused(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    chain_ranges: list | None = None,
    pre: tuple | None = None,
    pooled: bool = True,
) -> FusedPrep:
    """Build fused-kernel inputs from sequence-table ranges (see
    ``lz4tpu.device.fused.prep_fused``; native engine only).  Raises
    FusedOverflow for chains that exceed a kernel budget."""
    native_engine()
    if (pre is not None
            and (chain_ranges is None
                 or chain_ranges == [(0, lit_len.size)])):
        return _prep_fused_native_pre(
            lit_len, match_len, match_off, lit_src, buf, pre, pooled=pooled,
        )
    return _prep_fused_native(
        lit_len, match_len, match_off, lit_src, buf, chain_ranges,
        pooled=pooled,
    )


def _build_windows(lits_flat: np.ndarray, n_win: int) -> np.ndarray:
    """Overlapped 8 KiB literal windows at 4 KiB stride (vectorized)."""
    lit_pad = np.zeros(n_win * LITWIN_Q + LITWIN_Q, np.uint8)
    lit_pad[: lits_flat.size] = lits_flat
    wins = np.empty((n_win, 32, 256), np.uint8)
    body = lit_pad[: n_win * LITWIN_Q].reshape(n_win, 16, 256)
    wins[:, :16] = body
    wins[:-1, 16:] = body[1:]
    wins[-1, 16:] = lit_pad[
        n_win * LITWIN_Q: n_win * LITWIN_Q + LITWIN_Q
    ].reshape(16, 256)
    return wins


_POOL = threading.local()   # one pool per preparing thread
_POOL_DEPTH = 4


def _pool_arrays(nst: int, lit_cap: int, pooled: bool = True):
    """Rotating buffer pool for prep outputs (recycles warm pages of
    request-sized preps; ``LZ4TPU_PREP_POOL=0`` disables it).  Each
    thread has its own pool: a session's prep thread never hands out a
    buffer that a caller's decode on another thread still fills."""
    import collections
    import os

    if (not pooled
            or os.environ.get("LZ4TPU_PREP_POOL", "1") == "0"
            or nst > 2048):   # pool only request-sized preps (<=8 MiB)
        return (
            np.zeros(lit_cap, np.uint8),
            np.zeros(nst, np.int32),
            np.zeros((nst, 8), np.int32),
            np.zeros((nst, 2, 8, SEQ_MAX // 8), np.int32),
            np.zeros((nst, 8, PATCH_MAX // 8), np.int32),
            np.zeros((nst, 2), np.int32),
        )
    nst_b = -(-nst // 64) * 64
    lit_b = 1 << max(12, (lit_cap - 1).bit_length())
    key = (nst_b, lit_b)
    if not hasattr(_POOL, "queues"):
        _POOL.queues = {}
    q = _POOL.queues.setdefault(key, collections.deque())
    if len(q) >= _POOL_DEPTH:
        # buffers come back dirty: the native prep writes every live
        # slot and zeroes the tails itself, bounded by the high-water
        # array carried with the buffers
        bufs = q.popleft()
    else:
        bufs = (
            np.zeros(lit_b, np.uint8),
            np.zeros(nst_b, np.int32),
            np.zeros((nst_b, 8), np.int32),
            np.zeros((nst_b, 2, 8, SEQ_MAX // 8), np.int32),
            np.zeros((nst_b, 8, PATCH_MAX // 8), np.int32),
            np.zeros((nst_b, 2), np.int32),
        )
    q.append(bufs)
    lits_b, winq_b, scal_b, seqrec_b, patch_b, hw_b = bufs
    return (lits_b[:lit_cap], winq_b[:nst], scal_b[:nst],
            seqrec_b[:nst], patch_b[:nst], hw_b[:nst])


def _prep_fused_native_pre(lit_len, match_len, match_off, lit_src,
                           buf, pre, pooled: bool = True) -> FusedPrep:
    """Single-chain prep from ``native.scan_block_full`` outputs (phase
    1 already happened at scan time)."""
    native = native_engine()
    starts_ext, litpos_ext, lits_flat, max_off = pre
    S = lit_len.size
    n_out = int(starts_ext[S]) if S else 0
    n_lit = int(litpos_ext[S]) if S else 0
    n_sub = -(-n_out // SUB) if n_out else 0
    n_win = max(1, -(-max(1, n_lit) // LITWIN_Q))
    nst = max(n_sub, 1)
    _, winq, scal, seqrec, patch, hw = _pool_arrays(nst, 1, pooled)
    out_spans = [(0, 0, n_sub, n_out)]
    if n_sub == 0:
        return FusedPrep(
            seqrec=seqrec, lits=_build_windows(lits_flat[:0], n_win),
            winq=winq, scal=scal, patch=patch,
            n_sub=0, n_patches=0, n_seq_recs=0,
            out_spans=out_spans, max_off=max(1, int(max_off)),
        )
    buf8 = np.ascontiguousarray(buf, np.uint8)
    try:
        n_recs, n_patches, max_recs, max_patches = \
            native.prep_fused_chain_pre(
                np.ascontiguousarray(lit_len, np.int32),
                np.ascontiguousarray(match_len, np.int32),
                np.ascontiguousarray(match_off, np.int32),
                np.ascontiguousarray(lit_src, np.int32),
                buf8, n_win, starts_ext, litpos_ext, lits_flat, n_out,
                winq[:n_sub], scal[:n_sub], seqrec[:n_sub], patch[:n_sub],
                hw[:n_sub],
            )
    except ValueError as exc:
        raise FusedOverflow(str(exc)) from None
    return FusedPrep(
        seqrec=seqrec, lits=_build_windows(lits_flat[:n_lit], n_win),
        winq=winq, scal=scal, patch=patch,
        n_sub=n_sub, n_patches=n_patches, n_seq_recs=n_recs,
        out_spans=out_spans, max_off=max(1, int(max_off)),
        max_recs=max_recs, max_patches=max_patches,
    )


def _prep_fused_native(lit_len, match_len, match_off, lit_src, buf,
                       chain_ranges, pooled: bool = True) -> FusedPrep:
    native = native_engine()
    if chain_ranges is None:
        chain_ranges = [(0, lit_len.size)]
    metas = []
    lit_acc = 0
    n_sub_total = 0
    for cid, (lo, hi) in enumerate(chain_ranges):
        n_lit = int(np.sum(lit_len[lo:hi], dtype=np.int64))
        n_out = n_lit + int(np.sum(match_len[lo:hi], dtype=np.int64))
        n_sub_c = -(-n_out // SUB) if n_out else 0
        metas.append((cid, lo, hi, n_lit, n_out, n_sub_c,
                      lit_acc, n_sub_total))
        lit_acc += n_lit
        n_sub_total += n_sub_c
    n_win = max(1, -(-max(1, lit_acc) // LITWIN_Q))
    nst = max(n_sub_total, 1)
    lits_flat, winq, scal, seqrec, patch, hw = _pool_arrays(
        nst, max(lit_acc, 1), pooled
    )
    out_spans = []
    buf8 = np.ascontiguousarray(buf, np.uint8)

    def _one(meta):
        (_cid, lo, hi, n_lit, _n_out, n_sub_c, lit_base, sub0) = meta
        return native.prep_fused_chain(
            np.ascontiguousarray(lit_len[lo:hi], np.int32),
            np.ascontiguousarray(match_len[lo:hi], np.int32),
            np.ascontiguousarray(match_off[lo:hi], np.int32),
            np.ascontiguousarray(lit_src[lo:hi], np.int32),
            buf8, lit_base, n_win,
            lits_flat[lit_base:lit_base + max(n_lit, 1)],
            winq[sub0:sub0 + n_sub_c],
            scal[sub0:sub0 + n_sub_c],
            seqrec[sub0:sub0 + n_sub_c],
            patch[sub0:sub0 + n_sub_c],
            hw[sub0:sub0 + n_sub_c],
        )

    live = [m for m in metas if m[5] > 0]
    for (cid, _lo, _hi, _nl, n_out, n_sub_c, _lb, sub0) in metas:
        out_spans.append((cid, sub0, sub0 + n_sub_c, n_out))
    threads = native.pack_threads()
    try:
        if len(live) > 1 and threads > 1:
            # chains prep independently into disjoint array views and
            # the C function releases the GIL (ctypes)
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=min(threads, len(live))
            ) as ex:
                results = list(ex.map(_one, live))
        else:
            results = [_one(m) for m in live]
    except ValueError as exc:
        raise FusedOverflow(str(exc)) from None
    n_recs = sum(r[0] for r in results)
    n_patches = sum(r[1] for r in results)
    max_recs = max((r[2] for r in results), default=0)
    max_patches = max((r[3] for r in results), default=0)
    max_off = 1
    for (_cid, lo, hi, _nl, _no, n_sub_c, _lb, _s0) in metas:
        if n_sub_c and hi > lo:
            max_off = max(max_off, int(match_off[lo:hi].max()))
    return FusedPrep(
        seqrec=seqrec, lits=_build_windows(lits_flat[:lit_acc], n_win),
        winq=winq, scal=scal, patch=patch,
        n_sub=n_sub_total, n_patches=n_patches, n_seq_recs=n_recs,
        out_spans=out_spans, max_off=max_off,
        max_recs=max_recs, max_patches=max_patches,
    )


# ---------------------------------------------------------------------------
# expand: records + patches -> pos17 (kernel H1, first launch)
# ---------------------------------------------------------------------------

def expand(seqrec: torch.Tensor, scal: torch.Tensor,
           patch: torch.Tensor) -> torch.Tensor:
    """Per-byte sources of every substep: int32 ``(n_sub, SUB)``."""
    if seqrec.device.type == "cpu":
        return expand_plain(seqrec, scal, patch)
    n = seqrec.shape[0]
    _kernels.check(seqrec, "seqrec", torch.int32, (n, 2, 8, SEQ_MAX // 8))
    _kernels.check(scal, "scal", torch.int32, (n, 8), align=4)
    _kernels.check(patch, "patch", torch.int32, (n, 8, PATCH_MAX // 8))
    pos17 = torch.empty((n, SUB), dtype=torch.int32, device=seqrec.device)
    _kernels.launch(
        "fused_expand", "lz4t_fused_expand", seqrec.device,
        seqrec.data_ptr(), scal.data_ptr(), patch.data_ptr(),
        pos17.data_ptr(), n)
    return pos17


def _digit(r: torch.Tensor, shift: int) -> torch.Tensor:
    return ((r >> shift) & 255) - 128


def expand_plain(seqrec: torch.Tensor, scal: torch.Tensor,
                 patch: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch expand (golden_decode's record decode, scatter,
    prefix sum, pos17 and patch override), all substeps at once."""
    n = seqrec.shape[0]
    dev = seqrec.device
    # records decode as uint32 (int64 holds them without sign)
    r0 = seqrec[:, 0].reshape(n, -1).to(torch.int64) & 0xFFFFFFFF
    r1 = seqrec[:, 1].reshape(n, -1).to(torch.int64) & 0xFFFFFFFF
    live = r0 != 0
    deltas = torch.stack([
        _digit(r0, 12) + (_digit(r0, 20) << 8),
        _digit(r1, 0) + (_digit(r1, 8) << 8)
        + ((((r0 >> 28) & 7) - 4) << 16),
        _digit(r1, 16) + (_digit(r1, 24) << 8),
    ], 1) * live.unsqueeze(1)
    pos12 = (r0 & 0xFFF).unsqueeze(1).expand(-1, 3, -1)
    maps = torch.zeros((n, 3, SUB), dtype=torch.int64, device=dev)
    maps.scatter_add_(2, pos12, deltas)
    fields = maps.cumsum(2) + scal[:, 3:6].to(torch.int64).unsqueeze(2)
    u, v, b = fields.unbind(1)
    j = torch.arange(SUB, dtype=torch.int64, device=dev)
    pos = torch.where(j < b, j + u + U_BIAS, (j + v) & 0xFFFF)
    prec = patch.reshape(n, -1).to(torch.int64)
    code = prec & 0x3FFFF
    rows, slots = torch.nonzero((prec != 0) & (code >= TAG), as_tuple=True)
    pos[rows, prec[rows, slots] >> 18] = code[rows, slots] - TAG
    return pos.to(torch.int32)


# ---------------------------------------------------------------------------
# route: pos17 + literal windows + ring -> bytes (kernel H1, second launch)
# ---------------------------------------------------------------------------

def route(pos17: torch.Tensor, lits: torch.Tensor, winq: torch.Tensor,
          scal: torch.Tensor, segs: torch.Tensor,
          ring_in: torch.Tensor | None = None):
    """Route every segment ``segs[k] = (lo, hi, carry)`` of substeps in
    order through its ring; returns ``(rows, ring_out)``: uint8
    ``(n_sub * SUB,)`` and the last segment's final ``(65536,)`` ring."""
    if pos17.device.type == "cpu":
        return route_plain(pos17, lits, winq, scal, segs, ring_in)
    n = pos17.shape[0]
    dev = pos17.device
    _kernels.check(pos17, "pos17", torch.int32, (n, SUB))
    _kernels.check(lits, "lits", torch.uint8, (lits.shape[0], 32, 256))
    _kernels.check(winq, "winq", torch.int32, (n,), align=4)
    _kernels.check(scal, "scal", torch.int32, (n, 8), align=4)
    _kernels.check(segs, "segs", torch.int32, (segs.shape[0], 3), align=4)
    if ring_in is not None:
        _kernels.check(ring_in, "ring_in", torch.uint8, (RING,))
    rows = torch.empty(n * SUB, dtype=torch.uint8, device=dev)
    ring_out = torch.empty(RING, dtype=torch.uint8, device=dev)
    _kernels.launch(
        "fused_route", "lz4t_fused_route", dev,
        pos17.data_ptr(), lits.data_ptr(), winq.data_ptr(),
        scal.data_ptr(), segs.data_ptr(), segs.shape[0],
        _kernels.ptr(ring_in), rows.data_ptr(), ring_out.data_ptr())
    return rows, ring_out


def route_plain(pos17: torch.Tensor, lits: torch.Tensor,
                winq: torch.Tensor, scal: torch.Tensor, segs: torch.Tensor,
                ring_in: torch.Tensor | None = None):
    """Plain PyTorch route: golden_decode's serial substep loop."""
    dev = pos17.device
    n = pos17.shape[0]
    rows = torch.zeros(n * SUB, dtype=torch.uint8, device=dev)
    flat = lits.reshape(lits.shape[0], -1)
    wq = winq.tolist()
    sc = scal[:, :2].tolist()
    ring = zero_ring(dev)
    for lo, hi, carry in segs.tolist():
        ring = (ring_in.clone() if carry and ring_in is not None
                else zero_ring(dev))
        for i in range(lo, hi):
            row, wo = sc[i]
            win = flat[wq[i], wo * ROWB: wo * ROWB + LITWIN_Q]
            p = pos17[i].to(torch.int64)
            vals = torch.where(p >= RING,
                               win[(p - RING).clamp(0, LITWIN_Q - 1)],
                               ring[p.clamp(0, RING - 1)])
            rows[i * SUB:(i + 1) * SUB] = vals
            r = (row & 255) * ROWB
            ring[r:r + SUB] = vals
    return rows, ring


def decode_split(seqrec: torch.Tensor, lits: torch.Tensor,
                 winq: torch.Tensor, scal: torch.Tensor, patch: torch.Tensor,
                 ring_init: torch.Tensor | None = None, *, n_sub: int):
    """Two-launch decode of one chain's ``n_sub`` substeps: parallel
    expansion to pos17, then serial routing (the counterpart of
    ``lz4tpu.device.fused._decode_split_device``, whose two Pallas
    kernels kernel H1's two launches replace).  Returns ``(rows,
    ring_out)``: uint8 ``(n_sub * SUB,)`` and the final ``(65536,)``
    ring; ``ring_init`` seeds the ring (zeros when None)."""
    segs = segments_tensor([(0, n_sub, int(ring_init is not None))],
                           seqrec.device)
    pos17 = expand(seqrec[:n_sub], scal[:n_sub], patch[:n_sub])
    return route(pos17, lits, winq[:n_sub], scal[:n_sub], segs, ring_init)


# ---------------------------------------------------------------------------
# whole-prep decode
# ---------------------------------------------------------------------------

def _check_windows(winq: np.ndarray, scal: np.ndarray, n_win: int) -> None:
    """The route kernel reads 4 KiB at ``lits[winq[i]]`` row
    ``scal[i, 1]``: both must lie inside the prepared windows."""
    wo = scal[:, 1]
    if (int(winq.min()) < 0 or int(winq.max()) >= n_win
            or int(wo.min()) < 0 or int(wo.max()) > 16):
        raise ValueError("fused prep: literal window out of range")


def decode_fused_rows(prep: FusedPrep, device, ring_in=None,
                      part_subs: int | None = None):
    """Decode a FusedPrep on ``device``; returns ``(rows, ring_out)``:
    flat uint8 rows ``(n_sub * SUB,)`` (chain ``k``'s bytes at
    ``out_spans[k]``) and the final ring.  Preps beyond ``part_subs``
    substeps launch part by part at substep boundaries, each part's
    ring seeding the next (bounds the pos17 scratch at 4 B/byte of one
    part).  ``ring_in`` seeds the first chain's ring."""
    dev = torch.device(device)
    n = prep.n_sub
    if n == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                zero_ring(dev) if ring_in is None else ring_in)
    _check_windows(prep.winq[:n], prep.scal[:n], prep.lits.shape[0])
    part = part_subs or PART_SUBS
    bounds = [(p0, min(p0 + part, n)) for p0 in range(0, n, part)]
    lits = to_device(prep.lits, dev)
    seqrec = to_device(prep.seqrec[:n], dev)
    patch = to_device(prep.patch[:n], dev)
    # the small tables share one staging copy
    winq, scal, *part_segs = to_device_packed(
        [prep.winq[:n], prep.scal[:n]]
        + [segments_array(part_segments(prep.out_spans, p0, p1,
                                        seeded=ring_in is not None))
           for p0, p1 in bounds], dev)
    ring = ring_in
    parts = []
    for (p0, p1), segs in zip(bounds, part_segs):
        pos17 = expand(seqrec[p0:p1], scal[p0:p1], patch[p0:p1])
        rows, ring = route(pos17, lits, winq[p0:p1], scal[p0:p1], segs,
                           ring)
        parts.append(rows)
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), ring


# ---------------------------------------------------------------------------
# pipelined single-chain decode
# ---------------------------------------------------------------------------

PIPE_SUBS = 64         # pipelined-chunk substeps (128 KiB output)


def decode_fused_pipelined(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    pre: tuple,
    *,
    device,
    pipe_subs: int = PIPE_SUBS,
    counters: dict | None = None,
):
    """Single-chain decode with the host prep pipelined against the
    device (port of ``lz4tpu.device.fused.decode_fused_pipelined``): the
    chain is cut into ``pipe_subs``-substep chunks; each chunk's prep
    runs through the native range prep
    (``native.prep_fused_pre_range``), is staged through pinned memory
    without waiting for the stream, and launches kernel H1's expand and
    route at once, so the host preps chunk k+1 while the card decodes
    chunk k.  The ring chains on the card between launches (``ring_in``,
    one ``(0, pipe_subs, carry=1)`` segment).

    Every chunk is exactly ``pipe_subs`` substeps: the tail chunk is
    padded with zeroed prep content (zero records scatter nothing,
    zeroed scalars route into in-range pages) and its padded rows lie
    beyond ``n_out``.

    ``pre`` is the ``native.scan_block_full`` tuple (``SeqTable.pre``)
    or ``native.prep_phase1``'s.  Returns ``(flat_rows, n_out)``: uint8
    ``(n_chunks * pipe_subs * SUB,)`` on ``device``; raises
    FusedOverflow on any budget overflow.

    ``counters``: optional dict filled for tests: ``chunks`` (list of
    ``(i_lo, i_hi)``), ``prep_done_t`` / ``dispatch_t`` (monotonic
    stamps per chunk).
    """
    import time

    from .. import native

    if not native.available():
        raise FusedOverflow("pipelined decode requires the native engine")
    dev = torch.device(device)
    starts_ext, litpos_ext, lits_flat, _max_off = pre
    S = lit_len.size
    n_out = int(starts_ext[S]) if S else 0
    n_lit = int(litpos_ext[S]) if S else 0
    n_sub = -(-n_out // SUB) if n_out else 0
    if n_sub == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev), 0
    n_win = max(1, -(-max(1, n_lit) // LITWIN_Q))
    n_pad = -(-n_sub // pipe_subs) * pipe_subs
    _, winq, scal, seqrec, patch, hw = _pool_arrays(n_pad, 1)
    if n_pad > n_sub:
        # the tail chunk decodes zeroed substeps (pool buffers come
        # back dirty); their rows are sliced off
        winq[n_sub:] = 0
        scal[n_sub:] = 0
        seqrec[n_sub:] = 0
        patch[n_sub:] = 0
        hw[n_sub:] = 0
    lits_dev = to_device(_build_windows(lits_flat[:n_lit], n_win), dev)
    # exact per-substep record-count bound: records are the producing
    # sequences starting in a substep
    sizes = lit_len.astype(np.int64) + match_len
    prod = np.where(sizes > 0)[0]
    max_recs = (int(np.bincount(
        starts_ext[prod] // SUB, minlength=1).max()) if prod.size else 0)
    if max_recs > SEQ_MAX:
        raise FusedOverflow(
            f"{max_recs} seq records per substep (budget {SEQ_MAX})"
        )
    ll32 = np.ascontiguousarray(lit_len, np.int32)
    ml32 = np.ascontiguousarray(match_len, np.int32)
    mo32 = np.ascontiguousarray(match_off, np.int32)
    ls32 = np.ascontiguousarray(lit_src, np.int32)
    buf8 = np.ascontiguousarray(buf, np.uint8)
    segs_first, segs_carry = to_device_packed(
        [segments_array([(0, pipe_subs, 0)]),
         segments_array([(0, pipe_subs, 1)])], dev)
    parts = []
    ring = None
    for i_lo in range(0, n_sub, pipe_subs):
        i_hi = min(i_lo + pipe_subs, n_sub)
        try:
            native.prep_fused_pre_range(
                ll32, ml32, mo32, ls32, buf8, n_win,
                starts_ext, litpos_ext, lits_flat, n_out,
                i_lo, i_hi, winq, scal, seqrec, patch, hw,
            )
        except ValueError as exc:
            raise FusedOverflow(str(exc)) from None
        if counters is not None:
            counters.setdefault("chunks", []).append((i_lo, i_hi))
            counters.setdefault("prep_done_t", []).append(time.monotonic())
        sl = slice(i_lo, i_lo + pipe_subs)
        _check_windows(winq[sl], scal[sl], n_win)
        # one staging copy a chunk
        seqrec_dev, patch_dev, scal_dev, winq_dev = to_device_packed(
            [seqrec[sl], patch[sl], scal[sl], winq[sl]], dev)
        pos17 = expand(seqrec_dev, scal_dev, patch_dev)
        rows, ring = route(pos17, lits_dev, winq_dev, scal_dev,
                           segs_first if ring is None else segs_carry, ring)
        if counters is not None:
            counters.setdefault("dispatch_t", []).append(time.monotonic())
        parts.append(rows)
    return (torch.cat(parts) if len(parts) > 1 else parts[0]), n_out
