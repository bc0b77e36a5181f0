"""Batched device decode pipeline (port of ``lz4tpu.pipeline``): host
parse -> sequence tables -> device engines -> verification.

The host does the control-flow-heavy, byte-granular work over
*compressed* bytes (frame headers, token scan: O(compressed size),
native code); the device does all work proportional to *decompressed*
bytes.  The classifier (:func:`plan_decode`) gives each chain one
engine:

* sparse program (zeros/RLE, stored/incompressible): torch slicing
  plus the block-fill kernel;
* fused kernel (text within the fused budgets);
* mxu2 kernel (text that overflows the fused patch budget);
* segment-copy kernel / byte-parallel resolver (anything the fast
  paths decline; ``decompress_device(engine="pallas"|"resolve")``).

Verification parity: block checksums, content checksums, content-size
accounting and back-reference range checks all happen with the same
error class names and messages as the streaming core; when a
payload-level error is detected, the offending data is re-run through
the streaming oracle so the diagnostic (including embedded positions)
is byte-identical to the reference's.

A request of raw LZ4 blocks (no frame: :func:`decompress_blocks_to_device`,
the sizes from the caller's table) comes in by its own front
(:func:`_raw_front`) and shares the token scan, the classifier and the
executor with the frame entries.

``device`` is explicit everywhere: ``"cuda"`` runs the kernels and
raises when CUDA is absent; ``"cpu"`` runs every engine's plain PyTorch
version.

Nothing between the scan and the verification waits for the card: host
arrays are staged through pinned memory (``device.to_device``) and the
kernels launch on the calling thread's current stream, so a caller (or
``serve.DecodeSession``'s prep thread) goes on to the next request's
host work while the card decodes this one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from . import trace
from .constants import FOR_ALL, Reservation
from .device import fused as fu
from .device import mxu2 as mx
from .device import sparse_decode as sp
from .device import to_device
from .errors import (
    DataCorruption,
    Lz4Error,
    err_block_checksum,
    err_content_checksum,
    err_content_size_exceeded,
    err_content_size_leftover,
)
from .frame import ParseResult, parse_frames


@dataclasses.dataclass
class DecodeStats:
    """Observability counters for one device-pipeline decode.

    Counters and per-stage wall times, exposed via
    ``decompress_device(..., stats=...)``.  Times are seconds, each the
    host's time in the request's ``decode.<stage>`` spans
    (:mod:`lz4tpu_torch.trace`); ``device_s`` includes transfers and the
    host fetch of device-resident output (which synchronises the device).
    """

    comp_bytes: int = 0
    out_bytes: int = 0
    n_frames: int = 0
    n_blocks: int = 0
    n_chains: int = 0
    n_seqs: int = 0
    engine_chains: dict = dataclasses.field(default_factory=dict)
    engine_bytes: dict = dataclasses.field(default_factory=dict)
    parse_s: float = 0.0
    scan_s: float = 0.0
    plan_s: float = 0.0
    device_s: float = 0.0
    verify_s: float = 0.0
    dense_codes_s: float = 0.0
    device_codes: int = 0
    arena_blocks: int = 0
    raw_s: float = 0.0
    raw_literal_bytes: int = 0

    def read_spans(self, rec, request: int) -> None:
        """The ``*_s`` fields from ``request``'s spans in ``rec``, and
        from its counters ``device_codes`` (substeps whose mxu2 codes
        the card built), ``arena_blocks`` (blocks the one native scan
        wrote into the table) and ``raw_literal_bytes`` (literal bytes
        the scan of a request of raw blocks found)."""
        for stage in ("parse", "scan", "plan", "device", "verify", "raw"):
            setattr(self, f"{stage}_s",
                    rec.seconds(f"decode.{stage}", request))
        self.dense_codes_s = rec.seconds("decode.dense.codes", request)
        self.device_codes = rec.counters.get("decode.dense.device_codes", 0)
        self.arena_blocks = rec.counters.get("decode.scan.arena_blocks", 0)
        self.raw_literal_bytes = rec.counters.get(
            "decode.raw.literal_bytes", 0)

    def note_engine(self, name: str, chain) -> None:
        self.engine_chains[name] = self.engine_chains.get(name, 0) + 1
        self.engine_bytes[name] = (
            self.engine_bytes.get(name, 0) + chain.out_hi - chain.out_lo
        )


@dataclasses.dataclass
class BlockSpan:
    """Seq-table/output span of one block (for chain dispatch)."""

    frame_id: int
    seq_lo: int
    seq_hi: int
    out_lo: int
    out_hi: int
    independent: bool


@dataclasses.dataclass
class SeqTable:
    """Global structure-of-arrays sequence table for a whole buffer."""

    out_start: np.ndarray   # int32 [S] global output offset
    lit_len: np.ndarray     # int32 [S]
    lit_src: np.ndarray     # int32 [S] global offset into the input buffer
    match_len: np.ndarray   # int32 [S] 0 for trailing literal-only sequences
    match_off: np.ndarray   # int32 [S] >= 1 always
    n_out: int
    frame_out_start: np.ndarray  # int64 [F+1] output offsets of frame bounds
    spans: list = dataclasses.field(default_factory=list)  # [BlockSpan]
    # Single-block fast path only (build_seq_table(pooled_cols=True)):
    # (starts_ext[S+2], litpos_ext[S+2], lits_flat, max_off) from
    # native.scan_block_full — lets prep_fused skip its phase 1
    # (prefix sums + literal extraction).  When set, ALL columns are
    # views into per-thread scan scratch, invalidated by the thread's
    # next build_seq_table (as are the many-block path's pooled
    # columns) — the request pipeline consumes a table fully before
    # scanning the next request.
    pre: tuple | None = None


#: Calls of :func:`_host_fallback`.  On a frame the host engine decodes,
#: a device entry point that made one served the host's bytes (a batch
#: stage rejected a sound frame, or a device byte failed a checksum):
#: the soak and chip_smoke.py read this to see what the fallback hides.
HOST_FALLBACKS = 0
_FALLBACKS_LOCK = threading.Lock()


def _host_fallback(data, reservation: Reservation) -> bytes:
    """The streaming host engine, called from inside a device entry
    point: every such site of the package calls this, which counts
    itself in :data:`HOST_FALLBACKS`."""
    global HOST_FALLBACKS
    # looked up at the call, so that a caller may replace
    # api.decompress_host to refuse the fallback outright
    from .api import decompress_host

    with _FALLBACKS_LOCK:
        HOST_FALLBACKS += 1
    with trace.span("decode.fallback"):
        return decompress_host(data, reservation)


def _oracle_rerun(data: bytes, reservation: Reservation) -> None:
    """Raise the contract-exact error by re-running the streaming path.

    Always raises.  The expected outcome is the streaming engine's
    reference-parity exception for whatever the batch scan tripped on.
    If the push parser instead stalls (it waits for more input on a
    truncated tail rather than erroring) or — which would be a batch
    classifier bug — finishes cleanly, the no-progress diagnostic the
    one-shot streaming API uses is raised, so no caller can fall
    through to a made-up message."""
    from .stream import Decompressor

    reservation = Reservation(reservation)
    if reservation.is_concrete:
        _host_fallback(data, reservation)
    else:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        ctx, consumed = Decompressor.from_header(arr, reservation)
        stall = 0
        while consumed < arr.size and stall <= 4:
            got, _chunk = ctx.update(arr[consumed:])
            consumed += got
            stall = stall + 1 if got == 0 else 0
    raise DataCorruption("Decoder made no progress; corrupt input.")


class BatchCapacityExceeded(Exception):
    """The batched pipeline's sequence table uses int32 global output
    coordinates; streams decoding past 2**31-1 bytes must go through
    the (size-unbounded) streaming host engine instead.  Raised before
    any truncated coordinate can be used; callers fall back."""


_BATCH_MAX_OUT = (1 << 31) - 1


def _build_seq_table_single(
    buf: np.ndarray, parsed: ParseResult, reservation: Reservation, data
) -> SeqTable:
    """Single-compressed-block fast path: ONE native pass emits the
    columns (with the fused prep's sentinel slots), the cumulative
    literal positions, and the extracted literal stream — no column
    concatenation, no second prefix pass in prep (the dominant
    request shape: one frame, one block, e.g. any stream <= the 4 MiB
    max block size).  Columns alias per-thread scan scratch — see
    SeqTable.pre."""
    from . import native

    frame = parsed.frames[0]
    blk = frame.blocks[0]
    if blk.comp_off + blk.comp_len > _BATCH_MAX_OUT:
        raise BatchCapacityExceeded(blk.comp_off + blk.comp_len)
    with trace.span("decode.scan.blocks"):
        (status, starts_ext, ll, ls, ml, mo, litpos_ext, lits, total,
         min_reach, max_off) = native.scan_block_full(
            buf[blk.comp_off:blk.comp_off + blk.comp_len], blk.comp_off)
    if status != native.OK:
        _oracle_rerun(data, reservation)   # always raises
    if min_reach < 0:
        # back-reference before the frame start (lz4ada.adb:867-874)
        _oracle_rerun(data, reservation)   # always raises
    if total > _BATCH_MAX_OUT:
        raise BatchCapacityExceeded(total)
    if frame.content_size is not None:
        if total > frame.content_size:
            raise err_content_size_exceeded()
        if total < frame.content_size:
            raise err_content_size_leftover(frame.content_size - total)
    span = BlockSpan(
        frame_id=frame.frame_id,
        seq_lo=0, seq_hi=ll.size,
        out_lo=0, out_hi=total,
        independent=frame.block_independence,
    )
    return SeqTable(
        out_start=starts_ext[:ll.size],
        lit_len=ll, lit_src=ls, match_len=ml, match_off=mo,
        n_out=total,
        frame_out_start=np.array([0, total], np.int64),
        spans=[span],
        pre=(starts_ext, litpos_ext, lits, max_off),
    )


def build_seq_table(
    buf: np.ndarray, parsed: ParseResult, reservation: Reservation, data,
    pooled_cols: bool = False,
) -> SeqTable:
    """Token-scan every block into one global sequence table.

    Uncompressed blocks become single literal-only pseudo-sequences.
    Raises with reference parity on malformed payloads (via oracle
    re-run, so embedded diagnostic values match exactly).  Raises
    BatchCapacityExceeded when total output exceeds int32 coordinates
    (callers fall back to the streaming host engine).

    Every block but a lone compressed one is scanned by one native call
    on the calling thread (``native.scan_frames``, span
    ``decode.scan.blocks``; counter ``decode.scan.arena_blocks``, the
    blocks it scanned, where a recording is open): it writes the whole
    table at its global coordinates into this thread's scan scratch,
    stopping at the first block that fails.  The frame-level checks
    follow in stream order (span ``decode.scan.join``).

    ``pooled_cols=True`` (internal request paths) hands back columns
    that alias this thread's scan scratch, and enables the
    single-compressed-block fast path (see SeqTable.pre): valid until
    this thread's next build_seq_table call, so callers must fully
    consume the table before building another.  Default False always
    returns caller-owned arrays.
    """
    from . import native

    if (pooled_cols and native.available()
            and len(parsed.frames) == 1
            and len(parsed.frames[0].blocks) == 1
            and parsed.frames[0].blocks[0].is_compressed):
        return _build_seq_table_single(buf, parsed, reservation, data)

    blocks = np.array([(b.comp_off, b.comp_len, b.is_compressed)
                       for f in parsed.frames for b in f.blocks],
                      np.int64).reshape(-1, 3)
    done, status, res, cols = _scan_rows(buf, blocks)
    if not pooled_cols:
        cols = tuple(c.copy() for c in cols)
    with trace.span("decode.scan.join"):
        return _join_scans(parsed, done, status, res, cols, reservation,
                           data)


def _scan_rows(buf: np.ndarray, blocks: np.ndarray) -> tuple:
    """``native.scan_frames`` over the block rows ``(comp_off, comp_len,
    is_compressed)`` (span ``decode.scan.blocks``; counter
    ``decode.scan.arena_blocks``): its ``(done, status, res, cols)``,
    the columns in this thread's scan scratch."""
    from . import native

    with trace.span("decode.scan.blocks"):
        out = native.scan_frames(buf, blocks, _BATCH_MAX_OUT)
    trace.count("decode.scan.arena_blocks", out[0])
    return out


def _join_scans(parsed: ParseResult, done: int, status: int,
                res: np.ndarray, cols: tuple, reservation: Reservation,
                data) -> SeqTable:
    """The table of :func:`build_seq_table` from the native scan's
    per-block rows (``res``: ``(n_seq, total, min_reach)`` a block, the
    first ``done`` committed, block ``done`` failed with ``status``),
    with the checks that need frames, in stream order: the first
    malformed block wins."""
    from . import native

    # three lists of ints, not a list a block: fewer objects for the
    # collector to track
    seqs_of, totals, reaches = res.T.tolist()
    spans: list[BlockSpan] = []
    n_out = 0
    n_seq = 0
    k = 0
    frame_bounds = [0] * (len(parsed.frames) + 1)
    for frame in parsed.frames:
        frame_start_out = n_out
        frame_span_lo = len(spans)
        frame_crosses = False
        for blk in frame.blocks:
            if k == done:
                if blk.comp_off + blk.comp_len > _BATCH_MAX_OUT:
                    # input coordinates (lit_src / uncompressed
                    # pseudo-seq src) are int32 too
                    raise BatchCapacityExceeded(blk.comp_off + blk.comp_len)
                if status != native.E_COORD_RANGE:
                    _oracle_rerun(data, reservation)   # always raises
            seqs, total, min_reach = seqs_of[k], totals[k], reaches[k]
            k += 1
            if blk.is_compressed:
                # Back-reference range check: a match may not reach
                # before the start of its frame (equivalent to the
                # reference's H_Offset < 0 check, lz4ada.adb:867-874).
                if min_reach < frame_start_out:
                    _oracle_rerun(data, reservation)   # always raises
                if frame.block_independence and not frame_crosses:
                    # The reference ignores the B.Indep flag and always
                    # keeps history (SURVEY.md §2); tolerate streams
                    # whose flag lies by demoting the frame to linked
                    # chains.
                    frame_crosses = min_reach < n_out
            span = BlockSpan(
                frame_id=frame.frame_id,
                seq_lo=n_seq, seq_hi=n_seq + seqs,
                out_lo=n_out, out_hi=n_out + total,
                independent=frame.block_independence,
            )
            n_out += total
            if n_out > _BATCH_MAX_OUT:
                raise BatchCapacityExceeded(n_out)
            n_seq += seqs
            spans.append(span)
        if frame_crosses:
            for s in spans[frame_span_lo:]:
                s.independent = False
        frame_bounds[frame.frame_id + 1] = n_out

        # Content size accounting (reference: lz4ada.adb:469-476,
        # 826-839).
        if frame.content_size is not None:
            produced = n_out - frame_start_out
            if produced > frame.content_size:
                raise err_content_size_exceeded()
            if produced < frame.content_size:
                raise err_content_size_leftover(frame.content_size - produced)

    return SeqTable(
        out_start=cols[0],
        lit_len=cols[1],
        lit_src=cols[2],
        match_len=cols[3],
        match_off=cols[4],
        n_out=n_out,
        frame_out_start=np.array(frame_bounds, np.int64),
        spans=spans,
    )


def _verify_checksums(
    buf: np.ndarray, parsed: ParseResult, out: np.ndarray, table: SeqTable
) -> None:
    """Block + content checksum verification on the host (native
    xxh32); :func:`_verify_checksums_device` is the device form."""
    from . import native

    for frame in parsed.frames:
        for blk in frame.blocks:
            if blk.checksum is not None:
                payload = buf[blk.comp_off:blk.comp_off + blk.comp_len]
                computed = native.native_xxh32(payload)
                if computed != blk.checksum:
                    raise err_block_checksum(blk.checksum, computed)
        if frame.content_checksum is not None:
            lo = int(table.frame_out_start[frame.frame_id])
            hi = int(table.frame_out_start[frame.frame_id + 1])
            computed = native.native_xxh32(out[lo:hi])
            if computed != frame.content_checksum:
                raise err_content_checksum(computed, frame.content_checksum)


def _chains_of(table: SeqTable) -> list[BlockSpan]:
    """Group block spans into decode chains: independent blocks stand
    alone; linked blocks of a frame merge into one sequential chain."""
    chains: list[BlockSpan] = []
    for span in table.spans:
        if (
            chains
            and not span.independent
            and chains[-1].frame_id == span.frame_id
            and not chains[-1].independent
        ):
            chains[-1].seq_hi = span.seq_hi
            chains[-1].out_hi = span.out_hi
        else:
            chains.append(dataclasses.replace(span))
    return chains


@dataclasses.dataclass
class DecodePlan:
    """Per-input decode plan: which engine handles which chain.

    The classifier replaces the reference's single byte loop: the
    format's own structure decides the engine —
    * ``sparse``: few giant segments (zeros/RLE, incompressible,
      uncompressed blocks) -> segment program at device-memory speed
      (device/sparse_decode.py)
    * ``fused``: many small sequences (text) -> fused expansion +
      routing kernel (device/fused.py) — host work O(sequences)
    * ``dense``: fused-budget overflows (dense in-substep references)
      -> per-byte routing codes and their kernel (device/mxu2.py)
    * ``pallas``/``resolve``: anything the fast paths decline
      (oversized chains, pathological shapes)
    """

    sparse: list         # [(chain, SparseProgram)]
    dense_chains: list   # [chain]
    dense_pack: object   # DensePack2 (deferred: no codes yet) | None
    other: list          # [chain] -> segment kernel / resolver
    fused_chains: list = dataclasses.field(default_factory=list)
    fused_prep: object = None   # device.fused.FusedPrep | None


_SPARSE_MAX_SEQS = 512
# Fused-engine chain cap: prep ships ~3 B of records per output byte
# (seq records + patches + windows, padding included), so giant chains
# would hold multi-GB host/device transients; beyond the cap the part-wise
# host-pack engine (mxu2) takes over.
_FUSED_MAX_CHAIN_OUT = 64 << 20
# Chain-size caps for the dense packer: where the host packs (a decode
# on the CPU) the native resolver's host transient is the 4 B/byte code
# array (device memory stays bounded by part-wise launches,
# mxu2.PART_SUBS); the numpy resolver's pointer doubling needs ~40
# B/byte.
_DENSE_MAX_CHAIN_OUT = 1 << 30
_DENSE_MAX_CHAIN_OUT_NUMPY = 1 << 28


def plan_decode(buf: np.ndarray, parsed, table: SeqTable,
                stats: DecodeStats | None = None, chains: list | None = None,
                engine: str = "auto") -> DecodePlan:
    """Classify every chain and prepare the fused / mxu2 inputs: the
    plan of ``lz4tpu.pipeline.plan_decode`` (same engines per chain,
    same per-chain FusedOverflow isolation), the mxu2 chains in the
    deferred form (``mxu2.defer_dense2``: their codes are built when the
    plan is decoded).  Chains over the dense packer's cap go to
    ``plan.other`` (the resolver): the cap is
    ``_DENSE_MAX_CHAIN_OUT`` with the native engine,
    ``_DENSE_MAX_CHAIN_OUT_NUMPY`` without it.

    ``chains`` restricts planning to a subset (the sharded decode plans
    one mesh entry's share with it); default is every chain of the
    table.  ``engine``: "mxu2" sends fused-class chains to the host-pack
    engine; any other value plans as "auto" (fused first, the mxu2 pack
    for budget overflows), as ``lz4tpu`` does."""
    from . import native

    dense_cap = (_DENSE_MAX_CHAIN_OUT if native.available()
                 else _DENSE_MAX_CHAIN_OUT_NUMPY)
    plan = DecodePlan(sparse=[], dense_chains=[], dense_pack=None, other=[])
    dense_cand = []
    dense_ranges = []
    for chain in (_chains_of(table) if chains is None else chains):
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
        if n_out_c > dense_cap:
            plan.other.append(chain)
            if stats is not None:
                stats.note_engine("resolve", chain)
            continue
        dense_cand.append(chain)
    fused_cand = [c for c in dense_cand
                  if c.out_hi - c.out_lo <= _FUSED_MAX_CHAIN_OUT]
    dense_cand = [c for c in dense_cand if c not in fused_cand]
    if fused_cand and engine != "mxu2":

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
                trace.count("decode.fused.isolated", len(fused_cand))
                with trace.span("decode.plan.isolate"):
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
        # the codes are built where the decode runs (H9 on the card)
        plan.dense_pack = mx.defer_dense2(
            table.out_start, table.lit_len, table.match_len,
            table.match_off, table.lit_src, buf, chain_ranges=dense_ranges,
        )
    if trace.active():
        for name, planned in (("sparse", plan.sparse),
                              ("fused", plan.fused_chains),
                              ("dense", plan.dense_chains),
                              ("resolve", plan.other)):
            trace.count(f"decode.chains.{name}", len(planned))
    return plan


def _decode_front(data, reservation: Reservation) -> tuple:
    """The front of every decode request, whatever entry it comes in
    by: the bytes as a buffer, the frame parse (span ``decode.parse``;
    counters ``decode.frames`` and ``decode.blocks``, where a recording
    is open) and the token scan into one sequence table (span
    ``decode.scan``, its columns in the thread's scan scratch);
    ``(buf, parsed, table)``, or ``(buf, None, None)`` for an empty
    input.  ``BatchCapacityExceeded`` goes to the caller: each entry has
    its own answer to it."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if buf.size == 0:
        return buf, None, None
    with trace.span("decode.parse"):
        parsed = parse_frames(buf, reservation)
    if trace.active():
        trace.count("decode.frames", len(parsed.frames))
        trace.count("decode.blocks",
                    sum(len(f.blocks) for f in parsed.frames))
    with trace.span("decode.scan"):
        table = build_seq_table(buf, parsed, reservation, data,
                                pooled_cols=True)
    return buf, parsed, table


def _raw_front(data, comp_sizes, out_sizes,
               stats: DecodeStats | None = None) -> tuple:
    """The front of a request of raw LZ4 blocks (no frame), laid end to
    end in ``data``, block ``k`` ``comp_sizes[k]`` bytes long and stated
    to decode to ``out_sizes[k]``: the block rows of the shared token
    scan built from the sizes alone, the scan into one sequence table,
    each block an independent chain, and the plan; ``(buf, table,
    plan)``.

    Span ``decode.raw`` around it all, ``decode.scan`` and
    ``decode.plan`` inside; counters ``decode.raw.blocks`` (blocks
    handed in) and ``decode.raw.literal_bytes`` (literal bytes the scan
    found), each a request, where a recording is open.  Raises, for the
    first block at fault in block order, what
    ``Decompressor.for_block`` raises for a malformed block (its
    grammar, or a match that reaches before the block's start), and
    ``err_content_size_exceeded`` / ``err_content_size_leftover`` for a
    block that decodes to more or fewer bytes than stated;
    ``BatchCapacityExceeded`` past the int32 coordinates."""
    buf = np.frombuffer(data, np.uint8)
    comp = _block_sizes(comp_sizes, "comp_sizes")
    want = _block_sizes(out_sizes, "out_sizes")
    if comp.shape != want.shape:
        raise ValueError(f"{comp.size} comp_sizes but {want.size} out_sizes")
    ends = np.cumsum(comp)
    if ends.size and ends[-1] > buf.size:
        raise ValueError(f"the blocks' compressed sizes add up to "
                         f"{int(ends[-1])} bytes, past the {buf.size} of "
                         "data")
    with trace.span("decode.raw"):
        trace.count("decode.raw.blocks", comp.size)
        with trace.span("decode.scan"):
            blocks = np.stack([ends - comp, comp, np.ones_like(comp)], 1)
            table = _raw_table(buf, blocks, want, *_scan_rows(buf, blocks))
        if trace.active():
            trace.count("decode.raw.literal_bytes", int(table.lit_len.sum()))
        with trace.span("decode.plan"):
            plan = plan_decode(buf, None, table, stats)
    return buf, table, plan


def _block_sizes(sizes, name: str) -> np.ndarray:
    out = np.asarray(sizes, np.int64).reshape(-1)
    if out.size and out.min() < 0:
        raise ValueError(f"{name} holds a negative size")
    return out


def _raw_table(buf: np.ndarray, blocks: np.ndarray, want: np.ndarray,
               done: int, status: int, res: np.ndarray,
               cols: tuple) -> SeqTable:
    """The table of :func:`_raw_front` from the scan of its block rows,
    with each block held to its stated size and to its own start."""
    from . import native

    n = blocks.shape[0]
    # block `done`'s row is sound where only its coordinates failed
    sound = done + (done < n and status == native.E_COORD_RANGE
                    and blocks[done, 0] + blocks[done, 1] <= _BATCH_MAX_OUT)
    seqs, totals, reaches = res[:sound].T
    out_hi = np.cumsum(totals)
    out_lo = out_hi - totals
    bad = np.flatnonzero((reaches < out_lo) | (totals != want[:sound]))
    if bad.size:
        k = int(bad[0])
        if reaches[k] < out_lo[k]:
            _raw_block_error(buf, blocks[k])
        if totals[k] > want[k]:
            raise err_content_size_exceeded()
        raise err_content_size_leftover(int(want[k] - totals[k]))
    if done < n:
        if status != native.E_COORD_RANGE:
            _raw_block_error(buf, blocks[done])
        raise BatchCapacityExceeded(int(blocks[done, 0] + blocks[done, 1]))
    seq_hi = np.cumsum(seqs)
    spans = [BlockSpan(frame_id=k, seq_lo=s_hi - s, seq_hi=s_hi, out_lo=lo,
                       out_hi=hi, independent=True)
             for k, (s, s_hi, lo, hi) in enumerate(zip(
                 seqs.tolist(), seq_hi.tolist(), out_lo.tolist(),
                 out_hi.tolist()))]
    return SeqTable(
        out_start=cols[0], lit_len=cols[1], lit_src=cols[2],
        match_len=cols[3], match_off=cols[4],
        n_out=int(out_hi[-1]) if n else 0,
        frame_out_start=np.concatenate([[0], out_hi]).astype(np.int64),
        spans=spans,
    )


def _raw_block_error(buf: np.ndarray, row: np.ndarray) -> None:
    """Raise what the streaming engine's raw-block mode
    (``Decompressor.for_block``) raises for the block at ``row``
    ``(comp_off, comp_len, _)`` of ``buf``; always raises, with the
    no-progress diagnostic where that engine stalls or finishes."""
    from .stream import Decompressor

    src = buf[int(row[0]):int(row[0] + row[1])]
    ctx = Decompressor.for_block(src.size)
    consumed = stall = 0
    while consumed < src.size and stall <= 4:
        got, _chunk = ctx.update(src[consumed:])
        consumed += got
        stall = stall + 1 if got == 0 else 0
    raise DataCorruption("Decoder made no progress; corrupt input.")


def _verify_checksums_device(
    buf: np.ndarray, parsed: ParseResult, out_dev: torch.Tensor,
    table: SeqTable, comp_dev: torch.Tensor | None = None,
) -> None:
    """Checksum verification for device-resident output: content
    checksums cover decoded output and run as the xxh32 stream kernel
    over the device tensor; only lane states and stripe tails cross to
    the host.  Block checksums cover the COMPRESSED bytes: when the
    caller already staged them on the device (``comp_dev``), the
    batched per-block kernel hashes every block of a frame in one
    launch (``xxh32_blocks_device``); otherwise they run on the native
    engine over the host-resident buffer (faster than shipping bytes to
    hash them)."""
    from . import native
    from .device.xxh32_cuda import xxh32_blocks_device, xxh32_of_device_array

    # Frames verify IN ORDER, each frame's block checksums before its
    # content checksum: the same fault precedence as the host path and
    # the streaming reference (lz4ada.adb:672-676 runs per block inside
    # the frame, adb:491-513 at its end mark), so multi-fault inputs
    # raise the same error regardless of verify= mode.
    for frame in parsed.frames:
        blks = [b for b in frame.blocks if b.checksum is not None]
        if blks and comp_dev is not None:
            digests = xxh32_blocks_device(
                comp_dev,
                [b.comp_off for b in blks],
                [b.comp_len for b in blks],
            )
            for blk, computed in zip(blks, digests):
                if computed != blk.checksum:
                    raise err_block_checksum(blk.checksum, computed)
        else:
            for blk in blks:
                payload = buf[blk.comp_off:blk.comp_off + blk.comp_len]
                computed = native.native_xxh32(payload)
                if computed != blk.checksum:
                    raise err_block_checksum(blk.checksum, computed)
        if frame.content_checksum is not None:
            lo = int(table.frame_out_start[frame.frame_id])
            hi = int(table.frame_out_start[frame.frame_id + 1])
            computed = xxh32_of_device_array(out_dev, lo, hi)
            if computed != frame.content_checksum:
                raise err_content_checksum(computed, frame.content_checksum)


def _segment_tables(parsed: ParseResult, table: SeqTable,
                    chains: list) -> tuple[list, list]:
    """What ``lz4tpu.pipeline._decode_pallas`` hands its kernel, per
    chain: ``cols[k]`` (chain-local ``dst``, ``lit_src`` relative to
    the frame's start, ``lit_len``, ``match_off``, ``match_len``) and
    ``rows[k] = (n_seqs, frame start, output base, n_out)`` with the
    chains' outputs packed end to end."""
    cols, rows, out_base = [], [], 0
    for chain in chains:
        fr = parsed.frames[chain.frame_id]
        sl = slice(chain.seq_lo, chain.seq_hi)
        cols.append((
            (table.out_start[sl] - chain.out_lo).astype(np.int32),
            (table.lit_src[sl] - fr.start).astype(np.int32),
            table.lit_len[sl], table.match_off[sl], table.match_len[sl],
        ))
        n_loc = chain.out_hi - chain.out_lo
        rows.append((chain.seq_hi - chain.seq_lo, fr.start, out_base, n_loc))
        out_base += n_loc
    return cols, rows


def _segment_chains(parsed: ParseResult, table: SeqTable, chains: list,
                    comp_dev: torch.Tensor) -> list:
    """Decode ``chains`` through the segment-copy kernel, one chain per
    thread block in one launch: ``[(out_lo, uint8 tensor)]``."""
    from .device import segment_decode as sg

    chains = [c for c in chains if c.out_hi > c.out_lo]
    if not chains:
        return []
    cols, rows = _segment_tables(parsed, table, chains)
    out = sg.decode_chains_device(comp_dev, cols, rows)
    return [(chain.out_lo, out[base:base + n])
            for chain, (_s, _c, base, n) in zip(chains, rows)]


def _decode_pallas(buf: np.ndarray, parsed: ParseResult, table: SeqTable,
                   dev: torch.device) -> np.ndarray:
    """Chain-wise decode through the segment-copy kernel."""
    segs = _segment_chains(parsed, table, _chains_of(table),
                           to_device(buf, dev))
    return assemble_device_segments(segs, table.n_out, dev).cpu().numpy()


def _decode_via_plan(buf: np.ndarray, parsed: ParseResult, table: SeqTable,
                     plan: DecodePlan, dev: torch.device) -> np.ndarray:
    """Run a DecodePlan and fetch the assembled output to the host;
    stragglers (``plan.other``) go through the segment-copy kernel."""
    comp_dev = to_device(buf, dev) if plan.sparse or plan.other else None
    faults: list = []
    segs = build_device_segments(
        buf, table, dataclasses.replace(plan, other=[]), dev,
        comp_dev=comp_dev, faults=faults)
    segs += _segment_chains(parsed, table, plan.other, comp_dev)
    out = assemble_device_segments(segs, table.n_out, dev)
    mx.raise_on_fault(*faults)
    return out.cpu().numpy()


def _resolve_chain(buf: np.ndarray, table: SeqTable, chain,
                   comp_dev: torch.Tensor) -> torch.Tensor:
    """Byte-parallel resolver for one chain; the decoded bytes stay on
    ``comp_dev``'s device."""
    from .device import decode as dr

    dev = comp_dev.device
    sl = slice(chain.seq_lo, chain.seq_hi)
    n_loc = chain.out_hi - chain.out_lo
    produces = (table.lit_len[sl] + table.match_len[sl]) > 0
    return dr.resolve_sources(
        comp_dev,
        to_device((table.out_start[sl] - chain.out_lo).astype(np.int32),
                  dev),
        to_device(table.lit_len[sl], dev),
        to_device(table.lit_src[sl], dev),
        to_device(table.match_off[sl], dev),
        to_device(produces, dev),
        n_real=n_loc, n_out=n_loc,
        n_seqs=chain.seq_hi - chain.seq_lo,
    )


@dataclasses.dataclass
class _StagedPlan:
    """A DecodePlan's inputs on its device (:func:`_stage_plan`), ready
    for :func:`_launch_plan`."""

    plan: DecodePlan
    device: torch.device
    comp: torch.Tensor | None    # the compressed buffer
    dense: tuple | None          # mxu2.stage_dense2's tensors
    fused: object                # device.fused.StagedFused | None
    rings: list                  # [(out_lo, n_out, StagedFused)]


def _stage_plan(buf: np.ndarray, plan: DecodePlan, device,
                comp_dev: torch.Tensor | None = None,
                rings=()) -> _StagedPlan:
    """The executor's first step: the host work and the copies of
    ``plan`` on ``device``, queued on the current stream, nothing
    launched: the compressed buffer once (``comp_dev``: where the caller
    staged it already), the mxu2 engine's inputs and the fused prep.
    ``rings``: ``[(out_lo, n_out, FusedPrep, ring tensor or None)]``,
    spans of one chain that kernel H1 routes from a boundary ring (the
    sharded decode's span units)."""
    dev = torch.device(device)
    if comp_dev is None and (plan.sparse or plan.other
                             or plan.dense_pack is not None):
        comp_dev = to_device(buf, dev)
    fp = plan.fused_prep
    return _StagedPlan(
        plan=plan, device=dev, comp=comp_dev,
        dense=mx.stage_dense2(plan.dense_pack, dev, comp_dev),
        fused=(fu.stage_fused_rows(fp, dev)
               if fp is not None and fp.n_sub else None),
        rings=[(lo, n, fu.stage_fused_rows(prep, dev, ring_in=ring))
               for lo, n, prep, ring in rings])


def _launch_plan(buf: np.ndarray, table: SeqTable, st: _StagedPlan,
                 faults: list | None = None) -> list:
    """The executor's second step: queue the engines of a staged plan
    on the current stream: ``[(out_lo, uint8 tensor of exactly the
    chain's length)]``, ring-seeded spans first, then sparse, mxu2,
    fused and resolver chains.  ``faults``: where given, the mxu2
    engine's fault flags go there unread, for the caller to read with
    ``mxu2.raise_on_fault`` once it synchronises
    (``mxu2.decode_dense2_rows``); else that engine reads them as it
    launches."""
    plan, segs = st.plan, []
    for lo, n, staged in st.rings:
        with trace.span("decode.engine.fused"):
            segs.append((lo, fu.launch_fused_rows(staged)[0][:n]))
    for chain, prog in plan.sparse:
        with trace.span("decode.engine.sparse"):
            segs.append((chain.out_lo, sp.decode_sparse_device(
                prog, st.comp)[:chain.out_hi - chain.out_lo]))
    if plan.dense_pack is not None:
        with trace.span("decode.engine.dense"):
            flat, _ring = mx.decode_dense2_rows(
                plan.dense_pack, st.device, staged=st.dense, faults=faults)
            segs += _chain_rows(plan.dense_chains, plan.dense_pack, flat,
                                mx.SUB)
    if st.fused is not None:
        with trace.span("decode.engine.fused"):
            flat, _ring = fu.launch_fused_rows(st.fused)
            segs += _chain_rows(plan.fused_chains, plan.fused_prep, flat,
                                fu.SUB)
    for chain in plan.other:
        with trace.span("decode.engine.resolve"):
            segs.append((chain.out_lo,
                         _resolve_chain(buf, table, chain, st.comp)))
    return segs


def _chain_rows(chains: list, prep, flat: torch.Tensor, sub: int) -> list:
    """Each chain's bytes in a pack's or a prep's flat rows, as
    ``[(out_lo, uint8 tensor)]``."""
    return [(chain.out_lo, flat[slo * sub: slo * sub + out_len])
            for chain, (_c, slo, _shi, out_len) in zip(chains,
                                                       prep.out_spans)]


def build_device_segments(buf: np.ndarray, table: SeqTable,
                          plan: DecodePlan, device,
                          comp_dev: torch.Tensor | None = None,
                          faults: list | None = None) -> list:
    """Execute a DecodePlan on ``device`` (:func:`_stage_plan`, then
    :func:`_launch_plan`): ``[(out_lo, uint8 tensor of exactly the
    chain's length)]``.  ``comp_dev``: the compressed buffer already
    staged on ``device``, reused by the sparse programs, the mxu2 codes
    and the resolver.  ``faults``: as :func:`_launch_plan`'s."""
    with trace.span("decode.engines"):
        return _launch_plan(buf, table, _stage_plan(buf, plan, device,
                                                    comp_dev), faults)


def assemble_device_segments(segs: list, n_out: int, device) -> torch.Tensor:
    """Assemble ``[(out_lo, uint8 tensor)]`` into one ``(n_out,)``
    tensor (a single covering segment is returned as is)."""
    if (len(segs) == 1 and segs[0][0] == 0
            and segs[0][1].shape[0] == n_out):
        return segs[0][1]
    with trace.span("decode.assemble"):
        out = torch.zeros(n_out, dtype=torch.uint8, device=device)
        for lo, arr in segs:
            out[lo:lo + arr.shape[0]] = arr
    return out


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lz4tpu_torch: device='cuda' but CUDA is not available; pass "
            "device='cpu' for the plain PyTorch path")
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
    bytes, the same exceptions (class name and message) for the same
    input.  ``device`` is explicit: ``"cuda"`` (the default) runs the
    kernels and raises when CUDA is absent; ``"cpu"`` runs their plain
    PyTorch versions.

    verify: ``"host"`` copies the output to the host and checks block
    and content checksums there; ``"device"`` stages the compressed
    buffer once and verifies everything on the device (block checksums
    through the batched per-block xxh32 kernel, content checksums
    through the stream kernel over the device-resident output: decoded
    bytes never cross to the host, only lane states and sub-stripe
    tails), frame by frame in reference fault order; ``"none"`` skips
    the checksums (frame structure and sequence grammar are still
    validated host-side).

    out: optional caller 1-D uint8 tensor on ``device``; the decoded
    bytes are copied in place into ``out[:n]`` (the rest is left as it
    was) and ``out`` is returned.  Raises ``ValueError`` if it is too
    small, not 1-D uint8, or on another device.

    pipelined: accepted for calls written for ``lz4tpu`` and not read:
    the port decodes every input by the one plan.
    """
    dev = _resolve_device(device)
    with trace.span("decode"):
        try:
            res = _decompress_to_device_batch(data, reservation, dev, verify)
        except Lz4Error:
            # stream-order fault precedence: the streaming engine
            # re-derives the diagnostic; if it succeeds (batch-only
            # structural limitation) stage its bytes instead
            res = to_device(
                np.frombuffer(_host_fallback(data, reservation), np.uint8),
                dev)
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
    try:
        buf, parsed, table = _decode_front(data, reservation)
    except BatchCapacityExceeded as e:
        raise ValueError(
            "decompress_to_device: stream decodes past 2**31-1 bytes, "
            "beyond the batched pipeline's int32 coordinates; split the "
            "input by frame or use the streaming host engine"
        ) from e
    if table is None or table.n_out == 0:
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    comp_dev = None
    if verify == "device" and any(
        blk.checksum is not None
        for frame in parsed.frames
        for blk in frame.blocks
    ):
        # stage once: the batched per-block xxh32 kernel hashes the
        # compressed bytes on the device, and sparse programs reuse it
        comp_dev = to_device(buf, dev)
    with trace.span("decode.plan"):
        plan = plan_decode(buf, parsed, table)
    faults: list = []
    segs = build_device_segments(buf, table, plan, dev, comp_dev=comp_dev,
                                 faults=faults)
    out_dev = assemble_device_segments(segs, table.n_out, dev)
    # every launch is queued: the one wait for the mxu2 codes' flag
    mx.raise_on_fault(*faults)
    if verify == "host":
        with trace.span("decode.verify"):
            _verify_checksums(buf, parsed, out_dev.cpu().numpy(), table)
    elif verify == "device":
        with trace.span("decode.verify"):
            _verify_checksums_device(buf, parsed, out_dev, table,
                                     comp_dev=comp_dev)
    return out_dev


def decompress_blocks_to_device(
    data,
    comp_sizes,
    out_sizes,
    *,
    device="cuda",
    stats: DecodeStats | None = None,
) -> torch.Tensor:
    """Decode independent raw LZ4 blocks (the block format with no
    frame, no checksum and no size word: Parquet's LZ4_RAW pages) into
    one uint8 tensor on ``device``: the blocks' output end to end,
    ``sum(out_sizes)`` bytes.

    The batched form of nvCOMP's LZ4 API: ``data`` (bytes-like, a numpy
    array among them) holds the blocks end to end, block ``k``
    ``comp_sizes[k]`` bytes long and stated to decode to exactly
    ``out_sizes[k]`` bytes; a zero-length block decodes to nothing.  The
    request runs through its own front (:func:`_raw_front`: no frame
    parse) and then the frame entries' scan, planner and executor.
    There is no host fallback: a malformed block raises what
    ``Decompressor.for_block`` raises for it, a block that decodes to
    another size than stated raises ``DataCorruption``, sizes that run
    past ``data`` raise ``ValueError``.  ``device`` as in
    :func:`decompress_to_device`; ``stats``: filled in place, its times
    from the request's spans (``raw_s``: the front)."""
    dev = _resolve_device(device)
    with (trace.recording() if stats is not None
          else contextlib.nullcontext()) as rec, trace.span("decode") as req:
        try:
            try:
                buf, table, plan = _raw_front(data, comp_sizes, out_sizes,
                                              stats)
            except BatchCapacityExceeded as e:
                raise ValueError(
                    "decompress_blocks_to_device: the blocks decode past "
                    "2**31-1 bytes, beyond the batched pipeline's int32 "
                    "coordinates; split the request") from e
            if stats is not None:
                stats.comp_bytes = buf.size
                stats.out_bytes = table.n_out
                stats.n_blocks = len(table.spans)
                stats.n_seqs = int(table.out_start.size)
            if table.n_out == 0:
                return torch.zeros(0, dtype=torch.uint8, device=dev)
            faults: list = []
            segs = build_device_segments(buf, table, plan, dev,
                                         faults=faults)
            out = assemble_device_segments(segs, table.n_out, dev)
            mx.raise_on_fault(*faults)
            return out
        finally:
            if stats is not None:
                stats.read_spans(rec, req.request)


def decompress_device(
    data,
    reservation: Reservation = FOR_ALL,
    engine: str = "auto",
    *,
    device="cuda",
    stats: DecodeStats | None = None,
) -> bytes:
    """Decode a whole buffer via the device pipeline; returns bytes.

    engine: "auto" (classifier mix: sparse program / fused kernel /
    mxu2 kernel / segment kernel, see DecodePlan), "pallas" (the
    segment-copy kernel, chain-wise; the name is the JAX package's) or
    "resolve" (byte-parallel resolver).

    Fault precedence: the batch pipeline parses the whole frame
    structure before verifying checksums, so one corruption that
    creates BOTH an early checksum fault and a later structural fault
    would surface the wrong one (the reference reports stream order:
    lz4ada.adb:661-714 verifies each block's trailer as it reaches
    it).  Any Lz4Error therefore re-derives the diagnostic via the
    streaming host engine, the same contract as decompress_host's
    batch-to-streaming fallback.

    stats: filled in place; its times come from the request's spans,
    recorded only where ``stats`` is given.
    """
    dev = _resolve_device(device)
    with (trace.recording() if stats is not None
          else contextlib.nullcontext()) as rec, trace.span("decode") as req:
        try:
            return _decompress_device_batch(data, reservation, engine, dev,
                                            stats)
        except Lz4Error:
            return _host_fallback(data, reservation)
        finally:
            if stats is not None:
                stats.read_spans(rec, req.request)


def _decompress_device_batch(
    data,
    reservation: Reservation,
    engine: str,
    dev: torch.device,
    stats: DecodeStats | None,
) -> bytes:
    try:
        buf, parsed, table = _decode_front(data, reservation)
    except BatchCapacityExceeded:
        # stream decodes past int32 coordinates: the size-unbounded
        # streaming host engine takes over
        return _host_fallback(data, reservation)
    if table is None:
        return b""
    if stats is not None:
        stats.comp_bytes = buf.size
        stats.out_bytes = table.n_out
        stats.n_frames = len(parsed.frames)
        stats.n_blocks = sum(len(f.blocks) for f in parsed.frames)
        stats.n_seqs = int(table.out_start.size)
    if table.n_out == 0:
        return b""

    if engine == "auto":
        with trace.span("decode.plan"):
            plan = plan_decode(buf, parsed, table, stats)
        # the fetch to the host inside synchronises the device, so the
        # span covers the device work
        with trace.span("decode.device"):
            out_np = _decode_via_plan(buf, parsed, table, plan, dev)
        with trace.span("decode.verify"):
            _verify_checksums(buf, parsed, out_np, table)
        return out_np.tobytes()
    if engine == "pallas":
        out_np = _decode_pallas(buf, parsed, table, dev)
        _verify_checksums(buf, parsed, out_np, table)
        return out_np.tobytes()

    from .device import decode as dr

    produces = (table.lit_len + table.match_len) > 0
    out_np = dr.resolve_sources(
        to_device(buf, dev),
        to_device(table.out_start, dev),
        to_device(table.lit_len, dev),
        to_device(table.lit_src, dev),
        to_device(table.match_off, dev),
        to_device(produces, dev),
        n_real=table.n_out,
        n_out=table.n_out,
        n_seqs=table.out_start.size,
    ).cpu().numpy()
    _verify_checksums(buf, parsed, out_np, table)
    return out_np.tobytes()
