"""The program's own spans on the profiler's timeline, and what they say
of the card's idle time.

``lz4tpu_torch.trace`` records spans at the program's layer boundaries
and enters a ``torch.profiler.record_function`` range named
``lz4tpu_torch.<span>`` for each while a recording is open.  This module
reads those ranges from the profiler's events, on the clock of the
card's operations, and computes the program-span readings of a traced
run: host ms in the program's layers, the card's idle time under each
span, and the share of the staged bytes.  A program without
``lz4tpu_torch.trace`` records nothing, and every reading is None.

``python -m lz4bench.program_trace --workload <cell> --seed <n>`` sets
the cell up as a run does (inputs, entry, warm-up, the host fallback
refused), then

1. traces the cell's traced requests as ``tracing.traced_run`` does (the
   benchmark's spans around the program's functions, each request in a
   ``lz4bench.request`` range, the profiler on), with a recording of the
   program open around each request;
2. times the cell's requests in turns with and without a recording open,
   the profiler off;
3. times ``span`` and ``count`` with no recording open and with one;

and prints one JSON line: the readings below, the card's idle ms a
request under each program span (whole, and where it is the innermost
open), the longest idle gaps split by the innermost span over each part,
the accepted per-layer metrics of the
same traced run, the costs, and the checks of every answer.  It exits 2
where the program has no ``trace`` module, 3 without the device asked
for, 1 where an answer is wrong.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import sys
import time
import timeit

from . import harness, tracing

PREFIX = "lz4tpu_torch."
TOP = 10
#: the program's request spans: idle time under one of them alone is
#: not named
ROOTS = ("decode", "encode")


@dataclasses.dataclass
class ProgramTrace:
    """Each traced request's program spans and the card's busy time
    inside it, in the profiler's microseconds."""
    requests: list = dataclasses.field(default_factory=list)  # [(lo, hi)]
    spans: list = dataclasses.field(default_factory=list)  # [[(lo, hi, n)]]
    busy: list = dataclasses.field(default_factory=list)   # [[(lo, hi)]]
    h2d_bytes: int | None = None   # handed to the staging copies
    comp_bytes: int = 0            # of the requests' frames


def recording():
    """The program's ``trace.recording``, or None where it has none."""
    try:
        from lz4tpu_torch import trace
    except ImportError:
        return None
    return getattr(trace, "recording", None)


def collect(events, bench_spans: set) -> ProgramTrace:
    """Request windows, program spans and device operations from the
    profiler's events.  A device operation is what ``tracing`` counts as
    one: a CUDA event that is no annotation, no benchmark span and no
    program range."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ours = bench_spans | {tracing.REQUEST_SPAN}
    reqs, spans, ops = [], [], []
    for e in events:
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if (hi > lo and e.name not in ours
                    and not e.name.startswith(PREFIX)
                    and not getattr(e, "is_user_annotation", False)):
                ops.append((lo, hi))
        elif e.name == tracing.REQUEST_SPAN:
            reqs.append((lo, hi))
        elif e.name.startswith(PREFIX):
            spans.append((lo, hi, e.name[len(PREFIX):]))
    pt = ProgramTrace()
    for r_lo, r_hi in sorted(reqs):
        pt.requests.append((r_lo, r_hi))
        pt.spans.append(sorted(s for s in spans
                               if s[0] < r_hi and s[1] > r_lo))
        pt.busy.append(tracing._merge(
            (max(lo, r_lo), min(hi, r_hi)) for lo, hi in ops
            if lo < r_hi and hi > r_lo))
    return pt


# ---------------------------------------------------------------------------
# interval arithmetic
# ---------------------------------------------------------------------------

def _length(intervals) -> float:
    return sum(hi - lo for lo, hi in intervals)


def _intersect(a: list, b: list) -> list:
    """Two sorted lists of disjoint intervals: their common parts."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(pt: ProgramTrace, k: int) -> list:
    """The card's idle intervals inside request ``k``."""
    r_lo, r_hi = pt.requests[k]
    edges = [r_lo] + [x for b in pt.busy[k] for x in b] + [r_hi]
    return [(lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo]


def _under(pt: ProgramTrace, k: int, keep) -> list:
    """The union of request ``k``'s program spans whose name ``keep``
    takes, clipped to the request."""
    r_lo, r_hi = pt.requests[k]
    return tracing._merge((max(lo, r_lo), min(hi, r_hi))
                          for lo, hi, name in pt.spans[k] if keep(name))


def _recorded(pt: ProgramTrace) -> bool:
    return any(pt.spans)


# ---------------------------------------------------------------------------
# the readings (None where no request recorded its spans)
# ---------------------------------------------------------------------------

def span_ms(pt: ProgramTrace, names: set) -> float | None:
    """Host ms a request in the union of the spans ``names``."""
    if not _recorded(pt):
        return None
    return sum(_length(_under(pt, k, names.__contains__)) for k in
               range(len(pt.requests))) / len(pt.requests) / 1e3


def idle_ms(pt: ProgramTrace, names: set) -> float | None:
    """Card idle ms a request while the program is inside one of the spans
    ``names`` (the span itself or any span within it, whose interval lies
    inside)."""
    if not _recorded(pt):
        return None
    return sum(_length(_intersect(idle(pt, k),
                                  _under(pt, k, names.__contains__)))
               for k in range(len(pt.requests))) / len(pt.requests) / 1e3


def idle_named(pt: ProgramTrace) -> float | None:
    """The share of the card's idle time inside the requests that lies
    under a program span below the request span, in %."""
    if not _recorded(pt):
        return None
    total = named = 0.0
    for k in range(len(pt.requests)):
        gaps = idle(pt, k)
        total += _length(gaps)
        named += _length(_intersect(
            gaps, _under(pt, k, lambda n: n not in ROOTS)))
    return 100.0 * named / total if total > 0 else None


def staged_share(pt: ProgramTrace) -> float | None:
    """Bytes handed to the staging copies over the frames' bytes, in %."""
    if not _recorded(pt) or pt.h2d_bytes is None or pt.comp_bytes <= 0:
        return None
    return 100.0 * pt.h2d_bytes / pt.comp_bytes


READINGS = {
    "decode": {
        "prep_ms.decode": lambda pt: span_ms(
            pt, {"decode.parse", "decode.scan", "decode.plan"}),
        "pin_ms.decode": lambda pt: span_ms(pt, {"stage.pin"}),
        "staged_share.decode": staged_share,
        "engines_idle_ms.decode": lambda pt: idle_ms(pt, {"decode.engines"}),
        "idle_named.decode": idle_named,
    },
    "encode": {
        "issue_ms.encode": lambda pt: span_ms(pt, {"encode.issue"}),
        "fetch_ms.encode": lambda pt: span_ms(pt, {"encode.fetch"}),
        "idle_named.encode": idle_named,
    },
}


def idle_by_span(pt: ProgramTrace) -> dict:
    """Card idle ms a request under each program span name (the span's
    whole interval, its children's included)."""
    names = sorted({n for spans in pt.spans for _lo, _hi, n in spans})
    return {n: idle_ms(pt, {n}) for n in names}


def _segments(pt: ProgramTrace, k: int) -> list:
    """Request ``k``'s time cut wherever a span starts or ends: [(lo, hi,
    the innermost span open there)], the innermost being the shortest
    span that holds the piece (``request`` where none is open)."""
    r_lo, r_hi = pt.requests[k]
    cuts = sorted({r_lo, r_hi} | {min(max(x, r_lo), r_hi)
                                  for lo, hi, _n in pt.spans[k]
                                  for x in (lo, hi)})
    out = []
    for lo, hi in zip(cuts, cuts[1:]):
        inside = [(s_hi - s_lo, n) for s_lo, s_hi, n in pt.spans[k]
                  if s_lo <= lo and s_hi >= hi]
        out.append((lo, hi, min(inside)[1] if inside else "request"))
    return out


def _pieces(intervals: list, segments: list) -> dict:
    """The parts of sorted disjoint ``intervals`` in each innermost span,
    in us, by name."""
    got = collections.defaultdict(float)
    i = j = 0
    while i < len(intervals) and j < len(segments):
        lo = max(intervals[i][0], segments[j][0])
        hi = min(intervals[i][1], segments[j][1])
        if hi > lo:
            got[segments[j][2]] += hi - lo
        if intervals[i][1] < segments[j][1]:
            i += 1
        else:
            j += 1
    return got


def idle_self_by_span(pt: ProgramTrace) -> dict:
    """Card idle ms a request under each span where it is the innermost
    open: the request's idle time split among its spans, without
    overlap."""
    total = collections.defaultdict(float)
    for k in range(len(pt.requests)):
        for name, us in _pieces(idle(pt, k), _segments(pt, k)).items():
            total[name] += us
    n = max(len(pt.requests), 1)
    return {name: us / n / 1e3 for name, us in sorted(total.items())}


def longest_gaps(pt: ProgramTrace, top: int = TOP) -> list:
    """The ``top`` longest idle gaps inside the requests: [ms, {innermost
    span: ms of the gap under it}]."""
    gaps = sorted(((hi - lo, lo, hi, k) for k in range(len(pt.requests))
                   for lo, hi in idle(pt, k)), reverse=True)[:top]
    segments = {}
    out = []
    for us, lo, hi, k in gaps:
        if k not in segments:
            segments[k] = _segments(pt, k)
        under = _pieces([(lo, hi)], segments[k])
        out.append([us / 1e3, {n: v / 1e3 for n, v in sorted(
            under.items(), key=lambda kv: -kv[1])}])
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def traced(entry, cell, dev, rec_open) -> tuple:
    """The cell's traced requests as ``tracing.traced_run`` runs them,
    each inside a recording of the program: (Trace, ProgramTrace)."""
    import torch
    from torch.profiler import record_function

    rec = tracing._Recorder()
    tr = tracing.Trace(cell.traffic["entry"], torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")
    h2d = 0
    with tracing.wrapped(rec, entry, dev), tracing._profiler(dev) as prof:
        for i in range(cell.traffic["traced_requests"]):
            k = i % len(entry.requests)
            rec.spans.clear()
            c0 = sum(harness.cpu_times())
            s = time.perf_counter()
            with record_function(tracing.REQUEST_SPAN), rec_open() as prog:
                answer = entry.call(k)
                entry.sync()
            seconds = time.perf_counter() - s
            h2d += prog.counters.get("h2d_bytes", 0)
            tr.requests.append(tracing.TracedRequest(
                entry.raw_bytes(k), entry.comp_bytes(k, answer), seconds,
                sum(harness.cpu_times()) - c0, dict(rec.spans)))
            with record_function(tracing.CHECK_SPAN):
                entry.keep(k, answer)
                entry.sync()
            del answer
    pt = ProgramTrace()
    if prof is not None:
        names = set(tracing.span_files()) | {tracing.CHECK_SPAN}
        events = prof.events()
        tracing._read_profile(prof, tr, names)
        pt = collect(events, names)
    pt.h2d_bytes = h2d
    pt.comp_bytes = sum(r.comp for r in tr.requests)
    return tr, pt


def on_cost(entry, turns: int, rec_open) -> dict:
    """Request ms with a recording open and without, no profiler, in
    turns (plain, recorded, recorded, plain, ...) over every distinct
    request; each answer kept for the check."""
    times = {"plain": [], "recorded": []}

    def one(k, mode):
        s = time.perf_counter()
        if mode == "plain":
            answer = entry.call(k)
            entry.sync()
        else:
            with rec_open():
                answer = entry.call(k)
                entry.sync()
        times[mode].append((time.perf_counter() - s) * 1e3)
        entry.keep(k, answer)

    for t in range(turns):
        order = ("plain", "recorded") if t % 2 == 0 else ("recorded", "plain")
        for k in range(len(entry.requests)):
            for mode in order:
                one(k, mode)
    out = {f"{m}_ms": sorted(v) for m, v in times.items()}
    for m, v in times.items():
        out[f"{m}_median_ms"] = statistics.median(v)
    out["recorded_over_plain"] = (out["recorded_median_ms"]
                                  / out["plain_median_ms"])
    return out


def span_cost(number: int = 1_000_000) -> dict:
    """ns a call of ``span`` and ``count`` with no recording open, and
    with one open (no profiler; ``number // 10`` calls, the spans kept),
    best of five, beside the empty loop's."""
    from lz4tpu_torch import trace

    glb = {"span": trace.span, "count": trace.count}
    stmts = {"loop": "pass", "span": "span('decode.scan')",
             "with_span": "with span('decode.scan'): pass",
             "count": "count('h2d_bytes', 1)"}

    def best(stmt, n):
        return min(timeit.repeat(stmt, globals=glb, number=n, repeat=5)
                   ) / n * 1e9

    out = {f"off.{k}": best(s, number) for k, s in stmts.items()}
    with trace.recording():
        for k in ("with_span", "count"):
            out[f"on.{k}"] = best(stmts[k], number // 10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lz4bench.program_trace",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--turns", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=None,
                    help="bytes a request in place of the traffic's "
                    "(rehearsals)")
    args = ap.parse_args(argv)
    harness.program_environment()
    import torch

    rec_open = recording()
    if rec_open is None:
        harness.log("the program has no lz4tpu_torch.trace: nothing to read")
        return 2
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        harness.log("no CUDA device: no result")
        return 3
    cell = harness.load_cell(args.workload)
    requests = harness.make_requests(cell, args.seed, args.size)
    entry = harness.entry_class(cell.traffic["entry"])(
        requests, cell.config, cell.traffic, dev)
    with entry.fallback_refused():
        for _ in range(harness.WARMUP_PASSES):
            for k in range(len(requests)):
                entry.call(k)
                entry.sync()
        tr, pt = traced(entry, cell, dev, rec_open)
        costs = on_cost(entry, args.turns, rec_open)
        entry.after_window()
        checks = entry.judge()
    readings = {name: fn(pt) for name, fn in
                READINGS[cell.traffic["entry"]].items()}
    result = {
        "workload": cell.name, "seed": args.seed,
        "device": tr.device_kind,
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "program": readings,
        "idle_ms_by_span": idle_by_span(pt),
        "idle_self_ms_by_span": idle_self_by_span(pt),
        "longest_gaps": longest_gaps(pt),
        "accepted": {k: v["value"] for k, v in
                     harness.read_per_layer(cell, tr).items()},
        "busy_s": tr.busy_s, "window_s": tr.window_s,
        "breakdown": tr.breakdown,
        "request_ms": [r.seconds * 1e3 for r in tr.requests],
        "on_cost": costs, "span_cost_ns": span_cost(),
        "checks": checks,
        "counters": entry.counters(),
        "spans_a_request": {
            n: c / max(len(pt.requests), 1) for n, c in collections.Counter(
                n for spans in pt.spans for _lo, _hi, n in spans
            ).most_common()},
    }
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
