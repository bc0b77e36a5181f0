"""Fused decode engine for text-like chains (port of
``lz4tpu.device.fused``).

The host prep is the JAX package's, copied without JAX (that module
jits its launchers at import): sequence-table ranges become
per-substep records (``FusedPrep``), O(sequences) work, by the native
engine or, where it is absent, by the same prep in numpy
(:func:`_prep_fused_numpy`).  :func:`golden_decode` is the numpy spec
of what the records mean.  The device side is kernel H1
(``csrc/fused.cu``) as two launches:

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
part (:func:`decode_fused`: its bytes chain by chain);
:func:`decode_fused_pipelined` cuts one chain into 64-substep
chunks and launches each as soon as its range prep is done, the ring
carried on the card from chunk to chunk.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .. import _kernels
from . import to_device, to_device_packed
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
# host prep: JAX-free copy of lz4tpu/device/fused.py:138-786
# ---------------------------------------------------------------------------

SENTINEL = (1 << 31) - 1


def _first_seq(starts: np.ndarray, positions) -> np.ndarray:
    """Index of the sequence owning each output position."""
    return np.maximum(
        np.searchsorted(starts, positions, side="right") - 1, 0
    ).astype(np.int64)


def _digits256(x: np.ndarray, n: int):
    """Balanced base-256 digits d_k in [-128, 127] plus the remaining
    carry: x = sum d_k * 256^k + carry * 256^n (the record fields'
    packing)."""
    digits = []
    for _ in range(n):
        d = ((x + 128) & 255) - 128
        digits.append(d)
        x = (x - d) >> 8
    return digits, x


def _resolve_patches(pst, pll, pmo, pli, positions, sub_base):
    """Resolve in-substep chains (vectorized; one round a link).
    Returns per-position source codes: >= 0 ring position (mod 64 Ki),
    < 0 literal-stream position encoded as -(pos)-1."""
    p = positions.copy()
    out = np.zeros(p.size, np.int64)
    active = np.ones(p.size, bool)
    rounds = 0
    while active.any():
        rounds += 1
        if rounds > 64:
            raise FusedOverflow("patch chain deeper than 64")
        act_idx = np.where(active)[0]
        s = _first_seq(pst, p[act_idx])
        local = p[act_idx] - pst[s]
        is_lit = local < pll[s]
        lit_sel = np.where(is_lit)[0]
        out[act_idx[lit_sel]] = -(pli[s[lit_sel]] + local[lit_sel]) - 1
        hop = p[act_idx] - pmo[s]
        out_of_sub = (~is_lit) & (hop < sub_base[act_idx])
        osel = np.where(out_of_sub)[0]
        out[act_idx[osel]] = hop[osel] & 0xFFFF
        still = (~is_lit) & ~out_of_sub
        p[act_idx] = np.where(still, hop, p[act_idx])
        active[:] = False
        active[act_idx[np.where(still)[0]]] = True
    return out


def _group_scatter(sub_i, recs, n_sub, cap, what):
    """Group per-record rows by substep into (n_sub, cap) slot arrays."""
    counts = np.bincount(sub_i, minlength=n_sub)
    if counts.max() > cap:
        raise FusedOverflow(
            f"{int(counts.max())} {what} per substep (budget {cap})"
        )
    order = np.argsort(sub_i, kind="stable")
    # slot[k] is the within-substep slot of the k-th SORTED record
    slot = np.arange(sub_i.size) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    outs = []
    for r in recs:
        flat = np.zeros((n_sub, cap), np.int64)
        flat[sub_i[order], slot] = r[order]
        outs.append(flat)
    return outs


def _decode_records(r0, r1):
    """Record streams -> (pos12, dU, dV, dB)."""
    pos12 = r0 & 0xFFF
    dU = (((r0 >> 12) & 255) - 128) + ((((r0 >> 20) & 255) - 128) << 8)
    dV = (((r1 >> 0) & 255) - 128) + ((((r1 >> 8) & 255) - 128) << 8) \
        + ((((r0 >> 28) & 7) - 4) << 16)
    dB = (((r1 >> 16) & 255) - 128) + ((((r1 >> 24) & 255) - 128) << 8)
    return pos12, dU, dV, dB


def max_patches_per_substep(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    chain_ranges: list | None = None,
) -> int:
    """Exact per-substep in-substep-byte maximum in O(S + pieces), or
    ``1 << 30`` where a match spans more than 64 substeps.  A
    diagnostic (tests, capacity analysis): the planner does not screen
    with it, the prep fails on its own PATCH_MAX check."""
    if chain_ranges is None:
        chain_ranges = [(0, lit_len.size)]
    worst = 0
    for (lo, hi) in chain_ranges:
        ll = lit_len[lo:hi].astype(np.int64)
        ml = match_len[lo:hi].astype(np.int64)
        mo = match_off[lo:hi].astype(np.int64)
        sizes = ll + ml
        n_out = int(sizes.sum())
        if n_out == 0:
            continue
        starts = np.zeros(sizes.size + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        nbins = -(-n_out // SUB) + 1
        counts = np.zeros(nbins, np.int64)
        m0 = starts[:-1] + ll
        m1 = starts[1:]
        idx = np.where((mo < SUB) & (m1 > m0))[0]
        cur_lo, cur_mo, cur_hi = m0[idx], mo[idx], m1[idx]
        rounds = 0
        while cur_lo.size:
            rounds += 1
            if rounds > 64:
                return 1 << 30          # pathological: definitely over
            sb = (cur_lo // SUB) * SUB
            pe = np.minimum(cur_hi, sb + SUB)
            plo = np.maximum(cur_lo, sb + cur_mo)
            n_aff = np.maximum(pe - plo, 0)
            counts += np.bincount(cur_lo // SUB, weights=n_aff,
                                  minlength=nbins).astype(np.int64)
            nxt = pe < cur_hi
            cur_lo, cur_mo, cur_hi = pe[nxt], cur_mo[nxt], cur_hi[nxt]
        worst = max(worst, int(counts.max()))
    return worst


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
    ``lz4tpu.device.fused.prep_fused``).  Raises FusedOverflow for
    chains that exceed a kernel budget.

    With the native engine: phase 1 from ``pre`` (the
    ``native.scan_block_full`` tuple, single-chain tables only), or the
    native prep chain by chain.  Without it: :func:`_prep_fused_numpy`,
    which gives the same arrays but for the order of patch slots within
    a substep (the kernel's scatter does not depend on it), and the
    same overflow messages as ``lz4tpu``'s numpy prep."""
    from .. import native

    if not native.available():
        return _prep_fused_numpy(
            lit_len, match_len, match_off, lit_src, buf, chain_ranges)
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
    from .. import native

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
    from .. import native

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


def _prep_fused_numpy(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    chain_ranges: list | None = None,
) -> FusedPrep:
    """The prep in numpy, taken when the native engine is absent (a
    copy of ``lz4tpu``'s, its budgets and overflow messages included);
    the native prep's differential reference."""
    if chain_ranges is None:
        chain_ranges = [(0, lit_len.size)]

    # ---- pass 1: per-chain literal streams --------------------------
    chain_meta = []
    lit_parts = []
    lit_acc = 0
    n_sub_total = 0
    for cid, (lo, hi) in enumerate(chain_ranges):
        ll = lit_len[lo:hi].astype(np.int64)
        ml = match_len[lo:hi].astype(np.int64)
        mo = match_off[lo:hi].astype(np.int64)
        ls = lit_src[lo:hi].astype(np.int64)
        sizes = ll + ml
        n_out = int(sizes.sum())
        n_sub_c = -(-n_out // SUB) if n_out else 0
        starts = np.zeros(sizes.size + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        litpos = np.zeros(ll.size + 1, np.int64)
        np.cumsum(ll, out=litpos[1:])
        litpos += lit_acc
        n_lit = int(ll.sum())
        if n_lit:
            lseq = np.repeat(np.arange(ll.size), ll)
            lloc = (np.arange(n_lit, dtype=np.int64)
                    - np.repeat(litpos[:-1] - lit_acc, ll))
            lit_parts.append(buf[ls[lseq] + lloc])
        chain_meta.append(dict(
            cid=cid, starts=starts, ll=ll, mo=mo, litpos=litpos,
            n_out=n_out, n_sub=n_sub_c, sub0=n_sub_total,
        ))
        lit_acc += n_lit
        n_sub_total += n_sub_c
    lits_flat = (np.concatenate(lit_parts) if lit_parts
                 else np.zeros(0, np.uint8))
    n_win = max(1, -(-max(1, lits_flat.size) // LITWIN_Q))
    nst = max(n_sub_total, 1)

    # ---- pass 2: per-substep scalars, seq records, patches ----------
    scal = np.zeros((nst, 8), np.int32)
    winq = np.zeros(nst, np.int32)
    all_rec_sub, all_rec0, all_rec1 = [], [], []
    all_pat_sub, all_pat = [], []
    out_spans = []
    for m in chain_meta:
        cid, sub0, n_sub_c = m["cid"], m["sub0"], m["n_sub"]
        out_spans.append((cid, sub0, sub0 + n_sub_c, m["n_out"]))
        if n_sub_c == 0:
            continue
        starts, ll, mo, litpos = (m["starts"], m["ll"], m["mo"],
                                  m["litpos"])
        S = ll.size
        n_out = m["n_out"]
        pst = np.concatenate([starts[:-1], [n_out], [np.int64(SENTINEL)]])
        pll = np.concatenate([ll, [0, 0]])
        pmo = np.concatenate([mo, [1, 1]])
        pli = np.concatenate([litpos[:-1], [litpos[-1], litpos[-1]]])

        sub_ids = np.arange(n_sub_c, dtype=np.int64)
        sub_starts = sub_ids * SUB
        s0 = _first_seq(pst, sub_starts)
        # literal window per substep: first literal-stream byte consumed
        local0 = sub_starts - pst[s0]
        consumed = pli[s0] + np.minimum(np.maximum(local0, 0), pll[s0])
        wq = np.minimum(consumed // LITWIN_Q, n_win - 1)
        wo = ((consumed - wq * LITWIN_Q) >> 8) & ~np.int64(7)
        wabs = wq * (LITWIN_Q >> 8) + wo
        wb = wabs << 8
        winq[sub0:sub0 + n_sub_c] = wq
        scal[sub0:sub0 + n_sub_c, 0] = (sub_ids * (SUB // ROWB)) % RPAGES
        scal[sub0:sub0 + n_sub_c, 1] = wo
        scal[sub0:sub0 + n_sub_c, 2] = wabs

        # carry values: fields of the seq owning the last byte BEFORE
        # each substep (clipped — only read until the first record)
        cs = _first_seq(pst, np.maximum(sub_starts - 1, 0))
        u0 = np.clip(SUB + (pli[cs] - wb) - (pst[cs] - sub_starts),
                     0, 16383)
        v0 = (sub_starts - pmo[cs]) & 0xFFFF
        b0 = np.clip(pst[cs] + pll[cs] - sub_starts, 0, 8191)
        scal[sub0:sub0 + n_sub_c, 3] = u0
        scal[sub0:sub0 + n_sub_c, 4] = v0
        scal[sub0:sub0 + n_sub_c, 5] = b0
        # window-reload flag: substep 0 (incl. chain starts) and every
        # (winq, wabs) transition (the layout of lz4tpu's prep; H1's
        # route reads its window through winq and ignores it)
        flag = np.ones(n_sub_c, np.int64)
        if n_sub_c > 1:
            flag[1:] = ((wq[1:] != wq[:-1])
                        | (wabs[1:] != wabs[:-1])).astype(np.int64)
        scal[sub0:sub0 + n_sub_c, 6] = flag

        # ---- per-seq records (zero-output sequences dropped) --------
        sizes_s = pst[1:S + 1] - pst[:S]
        val = np.where(sizes_s > 0)[0]
        if val.size:
            st_v = pst[val]
            sub_i = st_v // SUB
            pos12 = st_v - sub_i * SUB
            U = SUB + (pli[val] - wb[sub_i]) - pos12
            if U.min() <= 0 or U.max() >= 16384:
                raise FusedOverflow("literal affine constant range")
            V = (sub_i * SUB - pmo[val]) & 0xFFFF
            B = np.clip(pos12 + pll[val], 0, 8191)
            same = np.zeros(val.size, bool)
            same[1:] = sub_i[1:] == sub_i[:-1]
            pU = np.where(same, np.roll(U, 1), u0[sub_i])
            pV = np.where(same, np.roll(V, 1), v0[sub_i])
            pB = np.where(same, np.roll(B, 1), b0[sub_i])
            (du0, du1), cu = _digits256(U - pU, 2)
            (dv0, dv1), cv = _digits256(V - pV, 2)
            (db0, db1), cb = _digits256(B - pB, 2)
            if (cu != 0).any() or (cb != 0).any() or (np.abs(cv) > 3).any():
                raise FusedOverflow("field delta exceeds digit range")
            rec0 = (pos12 | ((du0 + 128) << 12) | ((du1 + 128) << 20)
                    | ((cv + 4) << 28))
            rec1 = ((dv0 + 128) | ((dv1 + 128) << 8)
                    | ((db0 + 128) << 16) | ((db1 + 128) << 24))
            all_rec_sub.append(sub0 + sub_i)
            all_rec0.append(rec0)
            all_rec1.append(rec1)

        # ---- in-substep patches (vectorized over sequences) ---------
        m0 = pst[:S] + ll
        m1 = pst[1:S + 1]
        idx = np.where((mo < SUB) & (m1 > m0))[0]
        pos_parts = []
        cur_lo, cur_mo, cur_hi = m0[idx], mo[idx], m1[idx]
        rounds = 0
        while cur_lo.size:
            rounds += 1
            if rounds > 64:
                raise FusedOverflow("match spans cross >64 substeps")
            sb = (cur_lo // SUB) * SUB
            pe = np.minimum(cur_hi, sb + SUB)
            plo = np.maximum(cur_lo, sb + cur_mo)
            n_aff = np.maximum(pe - plo, 0)
            keep = n_aff > 0
            if keep.any():
                reps = n_aff[keep]
                base = np.repeat(plo[keep], reps)
                offs = (np.arange(int(reps.sum()), dtype=np.int64)
                        - np.repeat(np.cumsum(reps) - reps, reps))
                pos_parts.append(base + offs)
            nxt = pe < cur_hi
            cur_lo, cur_mo, cur_hi = pe[nxt], cur_mo[nxt], cur_hi[nxt]
        if pos_parts:
            pos = np.concatenate(pos_parts)
            sbp = (pos // SUB) * SUB
            res = _resolve_patches(pst, pll, pmo, pli, pos, sbp)
            sub_i = pos // SUB
            pwb = wb[sub_i]
            lit_rel = (-res - 1) - pwb
            is_l = res < 0
            if is_l.any() and (lit_rel[is_l].min() < 0
                               or lit_rel[is_l].max() >= WPAGES * 256):
                raise FusedOverflow("patch literal outside window")
            pos17 = np.where(is_l, 65536 + lit_rel, res)
            all_pat_sub.append(sub0 + sub_i)
            all_pat.append(((pos - sub_i * SUB) << 18) | pos17 | TAG)

    # ---- literal stream as overlapped 8 KiB windows -----------------
    wins = _build_windows(lits_flat, n_win)

    # ---- grouped record blocks --------------------------------------
    n_seq_recs = 0
    max_recs = 0
    seqrec = np.zeros((nst, 2, 8, SEQ_MAX // 8), np.int32)
    if all_rec0:
        sub_i = np.concatenate(all_rec_sub)
        r0 = np.concatenate(all_rec0)
        r1 = np.concatenate(all_rec1)
        n_seq_recs = r0.size
        max_recs = int(np.bincount(sub_i, minlength=nst).max())
        g0, g1 = _group_scatter(sub_i, [r0, r1], nst, SEQ_MAX,
                                "seq records")
        seqrec[:, 0] = g0.reshape(nst, 8, SEQ_MAX // 8)
        seqrec[:, 1] = g1.reshape(nst, 8, SEQ_MAX // 8)
    n_patches = 0
    max_patches = 0
    patch = np.zeros((nst, 8, PATCH_MAX // 8), np.int32)
    if all_pat:
        sub_i = np.concatenate(all_pat_sub)
        rec = np.concatenate(all_pat)
        n_patches = rec.size
        max_patches = int(np.bincount(sub_i, minlength=nst).max())
        (g,) = _group_scatter(sub_i, [rec], nst, PATCH_MAX, "patches")
        patch = g.reshape(nst, 8, PATCH_MAX // 8).astype(np.int32)

    max_off = 1
    for cid, (lo, hi) in enumerate(chain_ranges):
        if hi > lo and chain_meta[cid]["n_sub"]:
            max_off = max(max_off, int(match_off[lo:hi].max()))
    return FusedPrep(
        seqrec=seqrec, lits=wins, winq=winq, scal=scal, patch=patch,
        n_sub=n_sub_total, n_patches=n_patches, n_seq_recs=n_seq_recs,
        out_spans=out_spans, max_off=max_off,
        max_recs=max_recs, max_patches=max_patches,
    )


# ---------------------------------------------------------------------------
# numpy golden model of kernel H1 (the spec of the prep's arrays: tests
# hold it against the host engine, and the kernel and its plain version
# against it)
# ---------------------------------------------------------------------------

def golden_decode(prep: FusedPrep, ring_init=None) -> np.ndarray:
    """Reference implementation of the kernel's per-substep math —
    identical record decoding, scatter + prefix fill, patch override
    and source-position semantics; byte values read directly.

    ``ring_init``: optional uint8[65536] history seed in ring layout
    (flat index = chain output position mod 64 Ki) for span decode —
    the numpy analog of the kernel's ring_in (single-chain preps
    only; multi-chain preps reset the ring at every chain start)."""
    ring = np.zeros(65536, np.uint8)
    if ring_init is not None:
        ring[:] = ring_init
    lit_flat = np.zeros((prep.lits.shape[0] + 1) * LITWIN_Q, np.uint8)
    for w in range(prep.lits.shape[0]):
        lit_flat[w * LITWIN_Q: w * LITWIN_Q + 8192] = (
            prep.lits[w].reshape(-1)
        )
    out = np.zeros(prep.n_sub * SUB, np.uint8)
    chain_start = {slo for (_c, slo, shi, _n) in prep.out_spans
                   if shi > slo}
    if ring_init is not None:
        if not chain_start <= {0}:
            raise ValueError("golden_decode: ring_init is single-chain only")
        chain_start = set()
    jrel = np.arange(SUB, dtype=np.int64)
    for i in range(prep.n_sub):
        if i in chain_start:
            ring[:] = 0
        wabs = int(prep.scal[i, 2])
        win = lit_flat[wabs * 256: wabs * 256 + WPAGES * 256]
        u0, v0, b0 = (int(prep.scal[i, 3]), int(prep.scal[i, 4]),
                      int(prep.scal[i, 5]))
        r0 = prep.seqrec[i, 0].reshape(-1).astype(np.int64)
        r1 = prep.seqrec[i, 1].reshape(-1).astype(np.int64)
        live = r0 != 0
        pos12, dU, dV, dB = _decode_records(r0, r1)
        dmapU = np.zeros(SUB, np.int64)
        dmapV = np.zeros(SUB, np.int64)
        dmapB = np.zeros(SUB, np.int64)
        np.add.at(dmapU, pos12[live], dU[live])
        np.add.at(dmapV, pos12[live], dV[live])
        np.add.at(dmapB, pos12[live], dB[live])
        U = u0 + np.cumsum(dmapU)
        V = v0 + np.cumsum(dmapV)
        B = b0 + np.cumsum(dmapB)
        is_lit = jrel < B
        pos17 = np.where(is_lit, jrel + U + U_BIAS,
                         (jrel + V) & 0xFFFF)
        pv = np.zeros(SUB, np.int64)
        recs = prep.patch[i].reshape(-1).astype(np.int64)
        for r in recs[recs != 0]:
            pv[int(r) >> 18] = int(r) & 0x3FFFF
        pos17 = np.where(pv >= TAG, pv - TAG, pos17)
        vals = np.where(
            pos17 >= 65536,
            win[np.clip(pos17 - 65536, 0, WPAGES * 256 - 1)],
            ring[np.clip(pos17, 0, 65535)],
        ).astype(np.uint8)
        out[i * SUB:(i + 1) * SUB] = vals
        row = int(prep.scal[i, 0])
        ring.reshape(RPAGES, ROWB)[row:row + SUB // ROWB] = (
            vals.reshape(SUB // ROWB, ROWB)
        )
    return out


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


@dataclasses.dataclass
class StagedFused:
    """A FusedPrep staged on the device by :func:`stage_fused_rows`,
    ready for :func:`launch_fused_rows`."""

    device: torch.device
    lits: torch.Tensor
    seqrec: torch.Tensor
    patch: torch.Tensor
    winq: torch.Tensor
    scal: torch.Tensor
    bounds: list           # [(p0, p1)] substeps of each launch pair
    part_segs: list        # a segment table a launch pair
    ring_in: torch.Tensor | None


def stage_fused_rows(prep: FusedPrep, device, ring_in=None,
                     part_subs: int | None = None) -> StagedFused:
    """The host half of :func:`decode_fused_rows`: check the windows and
    stage every array the launches read (on the current stream), so a
    caller that decodes several preps can stage them all before it
    launches any."""
    dev = torch.device(device)
    n = prep.n_sub
    _check_windows(prep.winq[:n], prep.scal[:n], prep.lits.shape[0])
    part = part_subs or PART_SUBS
    bounds = [(p0, min(p0 + part, n)) for p0 in range(0, n, part)]
    # the small tables share one staging copy
    winq, scal, *part_segs = to_device_packed(
        [prep.winq[:n], prep.scal[:n]]
        + [segments_array(part_segments(prep.out_spans, p0, p1,
                                        seeded=ring_in is not None))
           for p0, p1 in bounds], dev)
    return StagedFused(
        device=dev, lits=to_device(prep.lits, dev),
        seqrec=to_device(prep.seqrec[:n], dev),
        patch=to_device(prep.patch[:n], dev), winq=winq, scal=scal,
        bounds=bounds, part_segs=part_segs, ring_in=ring_in)


def launch_fused_rows(st: StagedFused):
    """The device half of :func:`decode_fused_rows`: one expand and one
    route launch a part, each part's ring seeding the next."""
    ring = st.ring_in
    parts = []
    for (p0, p1), segs in zip(st.bounds, st.part_segs):
        pos17 = expand(st.seqrec[p0:p1], st.scal[p0:p1], st.patch[p0:p1])
        rows, ring = route(pos17, st.lits, st.winq[p0:p1], st.scal[p0:p1],
                           segs, ring)
        parts.append(rows)
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), ring


def decode_fused_rows(prep: FusedPrep, device, ring_in=None,
                      part_subs: int | None = None):
    """Decode a FusedPrep on ``device``; returns ``(rows, ring_out)``:
    flat uint8 rows ``(n_sub * SUB,)`` (chain ``k``'s bytes at
    ``out_spans[k]``) and the final ring.  Preps beyond ``part_subs``
    substeps launch part by part at substep boundaries, each part's
    ring seeding the next (bounds the pos17 scratch at 4 B/byte of one
    part).  ``ring_in`` seeds the first chain's ring."""
    dev = torch.device(device)
    if prep.n_sub == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                zero_ring(dev) if ring_in is None else ring_in)
    return launch_fused_rows(stage_fused_rows(prep, dev, ring_in, part_subs))


def decode_fused(prep: FusedPrep, device="cuda") -> list:
    """Decode a FusedPrep on ``device`` (``"cuda"`` by default; it
    raises without CUDA, ``"cpu"`` takes the plain versions); returns
    ``[(chain_id, bytes)]`` as ``lz4tpu.device.fused.decode_fused``
    does."""
    from ..pipeline import _resolve_device

    rows, _ring = decode_fused_rows(prep, _resolve_device(device))
    flat = rows.cpu().numpy()
    return [(cid, flat[slo * SUB: slo * SUB + n_out].tobytes())
            for (cid, slo, _shi, n_out) in prep.out_spans]


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
