"""Sharded LZ4 decode over a mesh of devices (port of the decode half of
``lz4tpu.dist``).

A mesh (:class:`Mesh`) is an ordered list of entries, each a device
with, on a CUDA device, a CUDA stream of its own: the counterpart of the
JAX package's device mesh, whose devices dispatch asynchronously.  A
mesh may list one device more than once (``[cuda:0] * 4``, or
``[cpu] * 8`` as the counterpart of the JAX tests' eight virtual CPU
devices); its entries then share that device, each on its own stream.
Across processes (:func:`initialize_multihost`, ``torch.distributed``)
the mesh is every process's entries, process by process.

Three tiers, as in ``lz4tpu``:

1. CHAIN-PARALLEL: chains (frames, independent blocks) are balanced
   across the entries by output bytes; each entry plans its share like
   the single-device pipeline (:func:`pipeline.plan_decode` with
   ``chains=``) and runs the same kernels.  No collective.
2. SPAN-PARALLEL: with fewer live chains than entries, a fused-class
   chain splits into 64 KiB-aligned spans (``lz4tpu_torch.spans``),
   slices of ONE whole-chain prep in chain coordinates, each routed by
   kernel H1 from its host-resolved boundary ring.  Spans schedule like
   chains (:class:`SpanUnit`).
3. RESOLVER SPAN-SHARDING for chains that cannot split: the output
   splits into equal spans, one an entry, each resolved by pointer
   doubling in torch ops; back-references reach at most 64 KiB back, so
   after local doubling every pointer that leaves a span lands in the
   64 KiB tail of an earlier one; the tails are exchanged (within a
   process, copied to every entry; across processes, one all-gather)
   and a short doubling pass over them resolves the rest.

Every tier-1/2 unit of an entry is staged and launched on that entry's
stream; all entries are staged before any launches, so the entries'
kernels overlap on the card instead of each waiting behind the next
entry's host work.  The caller's stream waits on each entry's stream
before the output is read, and tensors one stream allocates and another
reads are marked with ``record_stream``.

Tier choice and the work units are pure functions of ``(table, buf,
mesh size)``: every process computes them without talking to the others.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .constants import HISTORY_SIZE


# ---------------------------------------------------------------------------
# processes and meshes
# ---------------------------------------------------------------------------

def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device="cuda",
) -> None:
    """Join a group of decode processes (``torch.distributed``): NCCL
    when ``device`` is a CUDA device, gloo on the CPU.
    ``coordinator_address`` is ``host:port`` of process 0 (TCP
    rendezvous); without it the ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` variables of the environment are read.
    After this, :func:`make_mesh` builds a mesh over every process and
    ``decompress_sharded`` shards across all of them; every process
    returns the whole output."""
    import torch.distributed as tdist

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    tdist.init_process_group(backend, init_method=init, **kw)


def _process_count() -> int:
    tdist = torch.distributed
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_world_size()
    return 1


def _process_index() -> int:
    tdist = torch.distributed
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank()
    return 0


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (same shape everywhere), stacked in process
    order: ``(n_processes, *t.shape)``, on the CPU."""
    import torch.distributed as tdist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if tdist.get_backend() == "nccl" else torch.device("cpu"))
    x = t.to(dev).contiguous().reshape(-1)
    out = torch.empty(_process_count() * x.numel(), dtype=x.dtype,
                      device=dev)
    gather = (getattr(tdist, "all_gather_single", None)
              or tdist.all_gather_into_tensor)
    gather(out, x)
    return out.cpu().reshape(_process_count(), *t.shape)


def _any_process(flag: bool) -> bool:
    """``flag`` of any process."""
    if _process_count() == 1:
        return flag
    return bool(_all_gather(torch.tensor([int(flag)], dtype=torch.int32))
                .any())


@dataclasses.dataclass(frozen=True)
class MeshEntry:
    """One entry of a mesh: the process that owns it, its device, and
    (a CUDA entry of this process) its own stream."""

    process_index: int
    device: torch.device
    stream: object = None


class Mesh:
    """An ordered list of entries over ``devices`` (each a
    ``torch.device`` or its name; one device may repeat).  In a group of
    processes every process passes the same list, and the mesh holds
    every process's entries, process 0's first."""

    def __init__(self, devices):
        from .pipeline import _resolve_device

        local = []
        for d in devices:
            dev = _resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            local.append(dev)
        if not local:
            raise ValueError("a mesh needs at least one device")
        me = _process_index()
        self.entries = [
            MeshEntry(p, dev, torch.cuda.Stream(dev)
                      if p == me and dev.type == "cuda" else None)
            for p in range(_process_count()) for dev in local]

    @property
    def size(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:
        return f"Mesh({[str(e.device) for e in self.entries]})"


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh over ``device``: for ``"cuda"`` (no index) the first
    ``n_devices`` cards (every card when None); for one device
    (``"cuda:0"``, ``"cpu"``) that device listed ``n_devices`` times
    (once when None), each entry on a stream of its own.  ``"cuda"``
    raises where CUDA is absent."""
    from .pipeline import _resolve_device

    dev = _resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devs = devs[:n_devices]
    else:
        devs = [dev] * (1 if n_devices is None else n_devices)
    return Mesh(devs)


@contextlib.contextmanager
def _on(entry: MeshEntry, wait: bool = True):
    """Run the block on ``entry``'s stream; with ``wait``, after what
    the caller's stream has queued.  Callers join the entries only after
    the last one has launched (:func:`_join`): a join makes the caller's
    stream wait on the entry, and an entry that waited on the caller's
    stream after that would wait for the joined entry's kernels."""
    if entry.stream is None:
        yield
        return
    if wait:
        entry.stream.wait_stream(torch.cuda.current_stream(entry.device))
    with torch.cuda.stream(entry.stream):
        yield


def _join(entry: MeshEntry, tensors) -> None:
    """The caller's stream waits on ``entry``'s (an event), and the
    tensors that stream made are marked as read by the caller's."""
    if entry.stream is None:
        return
    cur = torch.cuda.current_stream(entry.device)
    cur.wait_stream(entry.stream)
    for t in tensors:
        t.record_stream(cur)


def _lend(entry: MeshEntry, tensors) -> None:
    """Mark tensors the caller's stream made as read by ``entry``'s."""
    if entry.stream is not None:
        for t in tensors:
            t.record_stream(entry.stream)


def _ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


# ---------------------------------------------------------------------------
# tier 3: the span-sharded resolver
# ---------------------------------------------------------------------------

def _local_resolve(out_start, lit_len, lit_src, match_off, produces,
                   n_real: int, *, d: int, span: int, local_iters: int):
    """The first half of ``lz4tpu.dist._local_resolve`` for entry ``d``:
    each byte of the entry's span as a pointer (``< 0``: a resolved
    literal, ``-(comp index) - 1``; ``>= 0``: an output position not yet
    resolved), after local pointer doubling; and whether an in-span
    pointer survived (the chain is deeper than ``2**local_iters``)."""
    dev = out_start.device
    lo = d * span
    pos = lo + torch.arange(span, dtype=torch.int32, device=dev)

    # Ownership: sequences starting before the span claim local position
    # 0, and the latest one (scatter-max) owns the span's first byte.
    # Claims beyond the span land in the extra slot, which is dropped.
    s_ids = torch.arange(out_start.shape[0], dtype=torch.int32, device=dev)
    local_start = torch.where(
        produces & (out_start < lo + span),
        (out_start - lo).clamp(min=0),
        torch.full_like(out_start, span))
    claims = torch.zeros(span + 1, dtype=torch.int32, device=dev)
    claims.scatter_reduce_(0, local_start.long(), s_ids, "amax")
    seq_id = torch.cummax(claims[:span], 0).values.long()

    os_ = out_start[seq_id]
    ll = lit_len[seq_id]
    ls = lit_src[seq_id]
    mo = match_off[seq_id]

    local = pos - os_
    mstart = os_ + ll
    lit_ptr = -(ls + local) - 1
    # A match byte equals every byte a multiple of mo before it, back to
    # mstart - mo: point at the latest one before max(mstart, lo).  A
    # match that began before the span then escapes at most mo (< 64 KiB)
    # before it, into the tails the exchange carries; folding back to
    # mstart - mo escapes as far as the match is long, past them.
    base = mstart.clamp(min=lo) - mo
    # lax.rem truncates toward zero, as fmod does (`%` would floor)
    match_ptr = base + torch.fmod(pos - base, mo)
    src = torch.where(local < ll, lit_ptr, match_ptr)
    src = torch.where(pos < n_real, src, torch.full_like(src, -1))

    # Local pointer doubling: a pointer before the span (an escape)
    # stays; every in-span pointer resolves or inherits an escape.
    for _ in range(local_iters):
        hop = src[(src - lo).clamp(0, span - 1).long()]
        src = torch.where(src >= lo, hop, src)
    # Convergence net: an in-span pointer left is NOT an escape (the
    # tail index would map it to a wrong slot), so the caller retries
    # with rounds enough for any in-span chain.
    return src, (src >= lo).any()


def _tail_index(p: torch.Tensor, span: int, w_tail: int) -> torch.Tensor:
    """Global position -> index into the gathered tails."""
    j = torch.div(p, span, rounding_mode="floor")
    return j * w_tail + (p - (j + 1) * span + w_tail)


def _tail_resolve(comp, src, tails, *, span: int, w_tail: int,
                  tail_iters: int) -> torch.Tensor:
    """The second half of ``lz4tpu.dist._local_resolve``: resolve the
    chains between tails (an escape in one tail points into an earlier
    one, at most D-1 deep), substitute the span's escapes through them,
    and gather the bytes."""
    n_t = tails.shape[0]
    for _ in range(tail_iters):
        hop = tails[_tail_index(tails, span, w_tail).clamp(0, n_t - 1)
                    .long()]
        tails = torch.where(tails >= 0, hop, tails)
    sub = tails[_tail_index(src, span, w_tail).clamp(0, n_t - 1).long()]
    src = torch.where(src >= 0, sub, src)
    return comp[(-src - 1).clamp(0, comp.shape[0] - 1).long()]


def decode_sharded(table, buf: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Decode a parsed and scanned buffer across every entry of
    ``mesh`` with the span-sharded resolver; ``table`` is a
    ``pipeline.SeqTable``; returns uint8[n_out] (every process returns
    all of it)."""
    from .device import to_device

    n_dev = mesh.size
    span = max(1024, -(-table.n_out // n_dev))
    span = (span + 127) & ~127
    w_tail = min(HISTORY_SIZE, span)
    # First attempt sizes rounds by the sequence count (each hop lands in
    # a strictly earlier sequence); if the convergence flag trips, retry
    # with rounds enough for ANY in-span chain (depth <= span).
    local_iters = min(16, _ceil_log2(max(2, table.out_start.size)) + 1)
    tail_iters = _ceil_log2(max(2, n_dev)) + 1
    local_iters_full = _ceil_log2(max(2, span)) + 1

    produces = (table.lit_len + table.match_len) > 0
    # match_off is 0 on a block's last sequence, whose bytes are all
    # literals; torch.fmod by an integer 0 raises where lax.rem does not
    host = (buf, table.out_start, table.lit_len, table.lit_src,
            np.maximum(table.match_off, 1), produces)
    me = _process_index()
    local = [(d, e) for d, e in enumerate(mesh.entries)
             if e.process_index == me]
    # the replicated inputs, staged once a device on the caller's stream
    staged = {}
    for _d, e in local:
        if e.device not in staged:
            staged[e.device] = [to_device(a, e.device) for a in host]

    def sources(iters):
        out = []
        for d, e in local:
            args = staged[e.device]
            _lend(e, args)
            with _on(e):
                out.append(_local_resolve(*args[1:], table.n_out, d=d,
                                          span=span, local_iters=iters))
        for (_d, e), o in zip(local, out):
            _join(e, o)
        # one host synchronisation, after every entry has launched
        flag = any(bool(u) for _s, u in out)
        return [s for s, _u in out], _any_process(flag)

    srcs, unresolved = sources(local_iters)
    if unresolved and local_iters_full > local_iters:
        srcs, unresolved = sources(local_iters_full)
    if unresolved:
        raise AssertionError(
            "span-sharded resolver failed to converge at full depth"
        )
    # the tail exchange, in mesh order
    tails = [s[span - w_tail:] for s in srcs]
    if _process_count() > 1:
        every = _all_gather(torch.cat([t.cpu() for t in tails]))
        every = every.reshape(-1)
    else:
        every = None
    outs = []
    for (d, e), src in zip(local, srcs):
        if every is None:
            gathered = torch.cat([t.to(e.device) for t in tails])
        else:
            gathered = to_device(every.numpy(), e.device)
        _lend(e, (src, gathered, staged[e.device][0]))
        with _on(e):
            outs.append(_tail_resolve(staged[e.device][0], src, gathered,
                                      span=span, w_tail=w_tail,
                                      tail_iters=tail_iters))
    for (_d, e), o in zip(local, outs):
        _join(e, [o])
    out = torch.cat([o.cpu() for o in outs])
    if _process_count() > 1:
        out = _all_gather(out).reshape(-1)
    return out.numpy()[: table.n_out]


# ---------------------------------------------------------------------------
# tiers 1 and 2: chains and span units
# ---------------------------------------------------------------------------

def _mesh_devices(mesh: Mesh) -> list:
    """Mesh entries interleaved across processes (process 0's first
    entry, process 1's first, ..., then every process's second), so that
    greedy chain assignment spreads load over processes first; the
    mesh's own order is process-major."""
    by_proc: dict = {}
    for e in mesh.entries:
        by_proc.setdefault(e.process_index, []).append(e)
    cols = list(by_proc.values())
    out = []
    i = 0
    while len(out) < mesh.size:
        for col in cols:
            if i < len(col):
                out.append(col[i])
        i += 1
    return out


class SpanUnit:
    """One span of a monolithic chain, scheduled like an independent
    chain (``lz4tpu_torch.spans``): a chain-coordinate slice of the
    chain's fused prep and the host-resolved 64 KiB boundary window that
    seeds its ring."""

    __slots__ = ("out_lo", "out_hi", "b_lo", "prep", "ring")

    def __init__(self, out_lo, out_hi, b_lo, prep, ring):
        self.out_lo = out_lo      # stream-global output range
        self.out_hi = out_hi
        self.b_lo = b_lo          # chain-local boundary (ring layout)
        self.prep = prep          # sliced FusedPrep (chain coordinates)
        self.ring = ring          # uint8[RING] window, or None (span 0)


def _work_units(table, buf: np.ndarray, n_dev: int,
                min_subs: int | None = None) -> tuple[list, bool]:
    """Chains, with under-parallel monolithic fused-class chains split
    into SpanUnits: with fewer live chains than entries, each big chain
    splits into spans sized toward equal work an entry, each decoded by
    kernel H1 from its boundary ring.

    A pure function of ``(table, buf, n_dev)`` (prep and ring-resolve
    overflows depend only on the data), which the ordered merge and
    :func:`sharded_span_assignment` rely on.  Chains that are
    sparse-class, over the fused cap, too small, or whose prep or ring
    resolution overflows stay whole.  Returns ``(units, any_split)``."""
    from . import spans as sp
    from .device import fused as fu
    from .pipeline import _FUSED_MAX_CHAIN_OUT, _SPARSE_MAX_SEQS, _chains_of

    if min_subs is None:
        min_subs = 2 * sp.RING_SUBS
    chains = _chains_of(table)
    live = [c for c in chains if c.out_hi > c.out_lo]
    if not live or len(live) >= n_dev:
        return chains, False
    total = sum(c.out_hi - c.out_lo for c in live)
    target = max(1, -(-total // n_dev))
    units: list = []
    any_split = False
    for c in chains:
        size = c.out_hi - c.out_lo
        n_seqs = c.seq_hi - c.seq_lo
        n_parts = min(n_dev, max(1, round(size / target)))
        if (
            n_parts <= 1
            or n_seqs <= _SPARSE_MAX_SEQS
            or size > _FUSED_MAX_CHAIN_OUT
            or size < 2 * min_subs * sp.SUB
        ):
            units.append(c)
            continue
        ranges = sp.plan_spans(size, n_parts, min_subs=min_subs)
        if len(ranges) <= 1:
            units.append(c)
            continue
        sl = slice(c.seq_lo, c.seq_hi)
        ll = table.lit_len[sl]
        ml = table.match_len[sl]
        mo = table.match_off[sl]
        ls = table.lit_src[sl]
        try:
            # pooled=False: the prep and its slices outlive the preps
            # made while other units are planned
            prep = fu.prep_fused(ll, ml, mo, ls, buf, pooled=False)
            rings = sp.resolve_rings(
                ll, ml, mo, ls, buf, [r0 * sp.SUB for r0, _ in ranges[1:]]
            )
        except (fu.FusedOverflow, sp.SpanResolveOverflow):
            units.append(c)
            continue
        for k, (r0, r1) in enumerate(ranges):
            out_len = min(r1 * sp.SUB, size) - r0 * sp.SUB
            units.append(SpanUnit(
                out_lo=c.out_lo + r0 * sp.SUB,
                out_hi=c.out_lo + r0 * sp.SUB + out_len,
                b_lo=r0 * sp.SUB,
                prep=sp.slice_prep(prep, r0, r1, out_len),
                ring=None if k == 0 else rings[k - 1],
            ))
        any_split = True
    return units, any_split


def _span_split_possible(table, n_dev: int,
                         min_subs: int | None = None) -> bool:
    """Cheap arithmetic screen: could :func:`_work_units` split
    anything?  (The decision itself also preps the chain and resolves
    its rings.)"""
    from . import spans as sp
    from .pipeline import _FUSED_MAX_CHAIN_OUT, _SPARSE_MAX_SEQS, _chains_of

    if min_subs is None:
        min_subs = 2 * sp.RING_SUBS
    chains = _chains_of(table)
    live = [c for c in chains if c.out_hi > c.out_lo]
    if not live or len(live) >= n_dev:
        return False
    total = sum(c.out_hi - c.out_lo for c in live)
    target = max(1, -(-total // n_dev))
    for c in live:
        size = c.out_hi - c.out_lo
        if (
            min(n_dev, max(1, round(size / target))) > 1
            and c.seq_hi - c.seq_lo > _SPARSE_MAX_SEQS
            and size <= _FUSED_MAX_CHAIN_OUT
            and size >= 2 * min_subs * sp.SUB
        ):
            return True
    return False


def _use_chains(table, n_dev: int) -> bool:
    """Tiers 1/2 (True) or the resolver (False): several chains, or a
    chain that may split into spans, each no larger than the dense
    packer's cap.  ``lz4tpu`` also sends large inputs to the resolver on
    its CPU platform, where its kernels run interpreted; the port
    chooses as ``lz4tpu`` does on an accelerator, on any device."""
    from .pipeline import _DENSE_MAX_CHAIN_OUT, _chains_of

    chains = _chains_of(table)
    return (
        (len(chains) > 1 or _span_split_possible(table, n_dev))
        and max(c.out_hi - c.out_lo for c in chains) <= _DENSE_MAX_CHAIN_OUT
    )


def _balance_chains(chains, n_dev: int) -> list[list[int]]:
    """Greedy largest-first assignment of chains to entries, balanced by
    OUTPUT bytes (expansion ratios differ, so input bytes are the wrong
    measure of load)."""
    order = sorted(
        range(len(chains)),
        key=lambda i: chains[i].out_hi - chains[i].out_lo,
        reverse=True,
    )
    load = [0] * n_dev
    groups: list[list[int]] = [[] for _ in range(n_dev)]
    for i in order:
        d = min(range(n_dev), key=load.__getitem__)
        groups[d].append(i)
        load[d] += chains[i].out_hi - chains[i].out_lo
    return groups


def _stage_span_unit(u: SpanUnit, device):
    """Stage one SpanUnit on the current stream; its boundary window
    (when any) seeds the ring of kernel H1's route."""
    from . import spans as sp
    from .device import fused as fu

    ring = (None if u.ring is None
            else sp.ring_seed_array(u.ring, u.b_lo, device))
    return fu.stage_fused_rows(u.prep, device, ring_in=ring)


def _launch_chain_groups(table, buf: np.ndarray, mesh: Mesh):
    """Launch phase of the sharded decoders: each entry of this process
    classifies its share like the single-device pipeline (sparse
    program, mxu2 pack, fused prep, resolver) and decodes it on its own
    stream.  Every entry's host work and staging runs before any entry
    launches.  Monolithic fused-class chains split into ring-seeded
    SpanUnits when there are fewer chains than entries.

    Returns ``(segs, units)``: ``[(out_lo, uint8 tensor of exactly the
    unit's length)]`` in the order of ``lz4tpu``'s handles (sparse,
    spans, mxu2, fused, resolver), each on its entry's device and ready
    on the caller's stream; and the work units."""
    from .device import fused as fu
    from .device import mxu2 as mx
    from .device import sparse_decode as sd
    from .device import to_device
    from .pipeline import _resolve_chain, plan_decode

    units, _split = _work_units(table, buf, mesh.size)
    entries = _mesh_devices(mesh)
    groups = _balance_chains(units, len(entries))
    me = _process_index()

    # (entry, spans [(unit, StagedFused)], plan, comp, dense, fused)
    staged = []
    for e, g in zip(entries, groups):
        if not g or e.process_index != me:
            continue
        g_chains = [units[i] for i in g if not isinstance(units[i], SpanUnit)]
        g_spans = [units[i] for i in g if isinstance(units[i], SpanUnit)]
        with _on(e):
            spans_e = [(u, _stage_span_unit(u, e.device)) for u in g_spans]
            plan = comp = dense_e = fused_e = None
            if g_chains:
                plan = plan_decode(buf, None, table, chains=g_chains)
                if plan.sparse or plan.other or plan.dense_pack is not None:
                    comp = to_device(buf, e.device)
                dense_e = mx.stage_dense2(plan.dense_pack, e.device, comp)
                fp = plan.fused_prep
                if fp is not None and fp.n_sub:
                    fused_e = fu.stage_fused_rows(fp, e.device)
        staged.append((e, spans_e, plan, comp, dense_e, fused_e))

    kinds = {k: [] for k in ("sparse", "span", "dense", "fused", "other")}
    made_by = []
    faults: list = []   # the mxu2 fault flags, read once all have launched
    for e, spans_e, plan, comp, dense_e, fused_e in staged:
        made = []
        made_by.append((e, made))
        with _on(e, wait=False):      # it waited when it was staged
            for u, st in spans_e:
                rows = fu.launch_fused_rows(st)[0]
                kinds["span"].append((u.out_lo, rows[: u.out_hi - u.out_lo]))
                made.append(rows)
            if plan is not None:
                for chain, prog in plan.sparse:
                    out = sd.decode_sparse_device(prog, comp)
                    kinds["sparse"].append(
                        (chain.out_lo, out[: chain.out_hi - chain.out_lo]))
                    made.append(out)
                pack = plan.dense_pack
                if pack is not None and pack.n_sub:
                    flat, _ring = mx.decode_dense2_rows(
                        pack, e.device, staged=dense_e, faults=faults)
                    made.append(flat)
                    for chain, (_c, slo, _shi, n) in zip(plan.dense_chains,
                                                          pack.out_spans):
                        kinds["dense"].append(
                            (chain.out_lo, flat[slo * mx.SUB:
                                                slo * mx.SUB + n]))
                if fused_e is not None:
                    flat, _ring = fu.launch_fused_rows(fused_e)
                    made.append(flat)
                    for chain, (_c, slo, _shi, n) in zip(
                            plan.fused_chains, plan.fused_prep.out_spans):
                        kinds["fused"].append(
                            (chain.out_lo, flat[slo * fu.SUB:
                                                slo * fu.SUB + n]))
                for chain in plan.other:
                    out = _resolve_chain(buf, table, chain, comp)
                    kinds["other"].append((chain.out_lo, out))
                    made.append(out)
    for e, made in made_by:
        _join(e, made)
    mx.raise_on_fault(*faults)
    return [s for k in kinds.values() for s in k], units


def sharded_span_assignment(table, buf: np.ndarray, mesh: Mesh) -> dict:
    """Deterministic unit -> process map of the device-resident decode:
    ``{process_index: [(out_lo, out_hi), ...]}``, spans that partition
    ``[0, n_out)``.  A pure function of ``(table, buf, mesh)``: every
    process computes the same map with no communication.  Units include
    the spans of split monolithic chains, so this preps any split
    chain."""
    units, _split = _work_units(table, buf, mesh.size)
    entries = _mesh_devices(mesh)
    groups = _balance_chains(units, len(entries))
    by_proc: dict = {}
    for e, g in zip(entries, groups):
        for i in g:
            c = units[i]
            if c.out_hi > c.out_lo:
                by_proc.setdefault(e.process_index, []).append(
                    (c.out_lo, c.out_hi)
                )
    for spans in by_proc.values():
        spans.sort()
    return by_proc


def decode_sharded_chains_to_device(table, buf: np.ndarray,
                                    mesh: Mesh) -> list:
    """Chain-parallel decode that leaves each unit on the device of the
    entry that decoded it: ``[(out_lo, uint8 tensor of exactly the
    unit's length)]``, ready on the caller's stream.  No host gather, no
    collective.  In a group of processes each returns only its own
    entries' units: the spans :func:`sharded_span_assignment` lists for
    it."""
    segs, _units = _launch_chain_groups(table, buf, mesh)
    return segs


def decode_sharded_chains(table, buf: np.ndarray,
                          mesh: Mesh) -> np.ndarray:
    """Chain-parallel decode to the host: every entry runs the
    single-device engines over its share; the units land in stream
    order.  In a group of processes the shares are merged so that every
    process returns the whole output (:func:`_multihost_ordered_merge`)."""
    segs, units = _launch_chain_groups(table, buf, mesh)
    multihost = _process_count() > 1
    out = (np.zeros if multihost else np.empty)(table.n_out, np.uint8)
    for lo, t in segs:
        out[lo:lo + t.shape[0]] = t.cpu().numpy()
    if multihost:
        out = _multihost_ordered_merge(out, table, mesh, units)
    return out


def _multihost_ordered_merge(out: np.ndarray, table, mesh: Mesh,
                             units: list) -> np.ndarray:
    """Each process ships only its own units' bytes, in unit order,
    padded to the largest share: one all-gather of O(n_out) bytes in
    all.  The unit -> process map is recomputed on every process
    (:func:`_work_units` and :func:`_balance_chains` are pure), so no
    index travels."""
    entries = _mesh_devices(mesh)
    groups = _balance_chains(units, len(entries))
    proc_units: list[list[int]] = [[] for _ in range(_process_count())]
    for e, g in zip(entries, groups):
        proc_units[e.process_index].extend(g)
    for pc in proc_units:
        pc.sort()
    shares = [sum(units[i].out_hi - units[i].out_lo for i in pc)
              for pc in proc_units]
    local = np.zeros(max(shares + [1]), np.uint8)
    off = 0
    for i in proc_units[_process_index()]:
        c = units[i]
        local[off:off + c.out_hi - c.out_lo] = out[c.out_lo:c.out_hi]
        off += c.out_hi - c.out_lo
    gathered = _all_gather(torch.from_numpy(local)).numpy()
    merged = np.zeros(table.n_out, np.uint8)
    for p, pc in enumerate(proc_units):
        off = 0
        for i in pc:
            c = units[i]
            n_c = c.out_hi - c.out_lo
            merged[c.out_lo:c.out_hi] = gathered[p, off:off + n_c]
            off += n_c
    return merged


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def decompress_sharded(data, mesh: Mesh | None = None, reservation=None,
                       *, device="cuda") -> bytes:
    """One-shot decode across a mesh (``make_mesh(device=device)`` when
    ``mesh`` is None; ``device`` is read only then).

    Chains shard onto the single-device engines; a monolithic
    fused-class chain splits into ring-seeded spans that schedule like
    chains; only chains that cannot split go to the span-sharded
    resolver.  Fault precedence is the streaming engine's: any Lz4Error
    re-derives the diagnostic through ``decompress_host``."""
    from .constants import FOR_ALL
    from .errors import Lz4Error

    if reservation is None:
        reservation = FOR_ALL
    try:
        return _decompress_sharded_batch(data, mesh, reservation, device)
    except Lz4Error:
        from .pipeline import _host_fallback

        return _host_fallback(data, reservation)


def _decompress_sharded_batch(data, mesh: Mesh | None, reservation,
                              device="cuda") -> bytes:
    from .frame import parse_frames
    from .pipeline import (BatchCapacityExceeded, _host_fallback,
                           _verify_checksums, build_seq_table)

    if mesh is None:
        mesh = make_mesh(device=device)
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if buf.size == 0:
        return b""
    parsed = parse_frames(buf, reservation)
    try:
        table = build_seq_table(buf, parsed, reservation, data,
                                pooled_cols=True)
    except BatchCapacityExceeded:
        # the stream decodes past int32 coordinates: the host engine
        return _host_fallback(data, reservation)
    if table.n_out == 0:
        return b""
    if _use_chains(table, mesh.size):
        out = decode_sharded_chains(table, buf, mesh)
    else:
        out = decode_sharded(table, buf, mesh)
    _verify_checksums(buf, parsed, out, table)
    return out.tobytes()


# ---------------------------------------------------------------------------
# data-parallel encode
# ---------------------------------------------------------------------------

def _compact_share(bufs: np.ndarray, mesh: Mesh, width_pad: int):
    """The compact candidate deltas, ``(n_pad, 2, width_pad)`` uint16 on
    the host, of the staged blocks ``bufs``: each entry takes a
    contiguous share of the block axis and runs the candidate pass over
    it batched, on its device and stream; this process computes its own
    entries' shares, and across processes one all-gather joins them (the
    entries are listed process by process, so each process's shares are
    one contiguous run of blocks)."""
    from .device import to_device
    from .device.encode import _candidates_compact_device

    per = bufs.shape[0] // mesh.size
    mine = [(i, e) for i, e in enumerate(mesh.entries)
            if e.process_index == _process_index()]
    lo = mine[0][0] * per
    made = []
    for i, e in mine:
        with _on(e):
            x = to_device(bufs[i * per:(i + 1) * per], e.device)
            made.append((i, e, _candidates_compact_device(x,
                                                          n_pad=width_pad)))
    local = np.empty((len(mine) * per, 2, width_pad), np.uint16)
    for i, e, d in made:           # every entry has launched: join them
        _join(e, [d])
        local[i * per - lo:(i + 1) * per - lo] = d.cpu().numpy()
    if _process_count() == 1:
        return local
    # the collectives move bytes: NCCL has no 16-bit integer type
    got = _all_gather(torch.from_numpy(local.view(np.uint8)))
    return got.numpy().view(np.uint16).reshape(bufs.shape[0], 2, width_pad)


def compress_sharded(
    data,
    mesh: Mesh | None = None,
    *,
    block_max_code: int = 7,
    content_checksum: bool = True,
    block_checksum: bool = False,
    content_size: bool = False,
    block_independence: bool = False,
) -> bytes:
    """LZ4 frame compression with block-parallel device match finding
    (``make_mesh()``, every card, when ``mesh`` is None).

    Encoding is embarrassingly parallel even with linked blocks: block
    k's 64 KiB history is *input* data, known upfront, so every block's
    sorted-gram candidate pass (``device/encode.py``) runs concurrently,
    batched along the block axis, which is sharded across the mesh.
    Token emission stays on the host per block (byte-granular), and the
    frame assembles in block order, so the output is bit-identical to
    ``compress(backend="device")``.
    """
    import struct

    from .api import _BLOCK_CODE_SIZE, _frame_descriptor
    from .constants import MAGIC_MODERN
    from .native import compress_block_cands
    from .xxh32 import xxh32

    data = bytes(data)
    if mesh is None:
        mesh = make_mesh()
    block_max = _BLOCK_CODE_SIZE[block_max_code]
    n_blocks = -(-len(data) // block_max)     # 0 blocks for empty input
    HCAP = HISTORY_SIZE

    # Stage fixed-shape per-block buffers: [zero pad | history | block].
    width = HCAP + block_max
    width_pad = (width + 1023) // 1024 * 1024
    n_pad = -(-n_blocks // mesh.size) * mesh.size
    bufs = np.zeros((n_pad, width_pad), np.uint8)
    first_valid = np.zeros(n_pad, np.int32)
    spans = []
    for b in range(n_blocks):
        pos = b * block_max
        chunk = data[pos:pos + block_max]
        hist = b"" if block_independence else data[max(0, pos - HCAP):pos]
        bufs[b, HCAP - len(hist):HCAP] = np.frombuffer(hist, np.uint8)
        bufs[b, HCAP:HCAP + len(chunk)] = np.frombuffer(chunk, np.uint8)
        first_valid[b] = HCAP - len(hist)
        spans.append((len(hist), len(chunk)))

    if n_blocks:
        cands = _compact_share(bufs, mesh, width_pad)

    out = bytearray(struct.pack("<I", MAGIC_MODERN))
    out += _frame_descriptor(
        len(data) if content_size else None,
        block_max_code, content_checksum, block_checksum,
        block_independence,
    )
    for b in range(n_blocks):
        hist_len, src_len = spans[b]
        fv = int(first_valid[b])
        # Hand the emitter a buffer that STARTS at the first real byte:
        # its backward match extension stops at position 0, so it can
        # never walk into the zero padding before the history (which
        # would emit back-references reaching before the frame start).
        # Deltas -> positions rebased to fv; a delta reaching before fv
        # (into the zero padding) is dropped, and the last 3/7 real
        # positions are masked exactly like compact_candidates does
        # (their grams read past the real data), keeping the sharded
        # frame bit-identical to the sequential device encoder.
        L = HCAP + src_len - fv
        d = np.array(cands[b, :, fv:HCAP + src_len], np.int32)
        d[0, max(0, L - 3):] = 0
        d[1, max(0, L - 7):] = 0
        rel = np.arange(L, dtype=np.int32)
        cand = np.where((d > 0) & (rel[None, :] - d >= 0),
                        rel[None, :] - d, -1).astype(np.int32)
        comp = compress_block_cands(
            bufs[b, fv:], HCAP - fv, src_len, cand, lazy=True
        )
        chunk = data[b * block_max: b * block_max + src_len]
        if comp and len(comp) < src_len:
            out += struct.pack("<I", len(comp))
            out += comp
            blk = comp
        else:
            out += struct.pack("<I", src_len | 0x80000000)
            out += chunk
            blk = chunk
        if block_checksum:
            out += struct.pack("<I", xxh32(blk))
    out += b"\x00\x00\x00\x00"
    if content_checksum:
        out += struct.pack("<I", xxh32(data))
    return bytes(out)
