"""The bench's cells: an untimed warm-up, an untraced end-to-end run,
then a separate traced run for the per-layer numbers, and one JSON line.

End to end, a request is timed on the host clock from the entry point's
call to a synchronise after it returns, so everything the caller waits
for is inside: frame parse, token scan, plan, staging, the kernels and
the checksums on the card (``verify="device"``).  Every output is held
against the original bytes after its timed window closes.

The traced run replays ``decompress_to_device``'s steps in this file,
each inside a ``torch.profiler.record_function`` span of its name
(``parse``, ``scan``, ``plan``, ``stage``, ``engines``, ``verify``),
with a synchronise after each step, so a step's host time holds the
device work it queued; ``engines_ms`` is read from CUDA events around
the engines.  The session's traced rounds carry the spans ``submit``,
``result_on_device`` and ``sync``.  Device busy share, kernel times and
the breakdown come from the profiler's device events; where it records
none, they are "not measured".  Beside the end-to-end run, the host's
readings (:mod:`bench_torch.host`) say how busy the machine was.
"""

from __future__ import annotations

import collections
import contextlib
import math
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import lz4tpu_torch as lt
from lz4tpu_torch import _kernels, api, native
from lz4tpu_torch import pipeline as pl
from lz4tpu_torch.device import to_device

from . import corpora, host

TIMED = 40              # timed requests of a single-request cell
WARMUP_PASSES = 2       # untimed passes over a cell's distinct requests
SESSION_ROUNDS = 3      # timed rounds of session-mix (72 requests)
SESSION_INFLIGHT = 4
TRACED_PASSES = 3       # traced passes over a cell's distinct requests
CELL_BUDGET_S = 300.0
TOP = 5                 # rows of each breakdown list
NOT_MEASURED = "not measured"

#: Counted kernel -> (port kernel, the CUDA functions it launches).
KERNELS = {
    "fused_expand": ("H1", ("fused_expand_kernel",)),
    "fused_route": ("H1", ("fused_route_kernel",)),
    "block_fill": ("H2", ("block_fill_kernel",)),
    "mxu2_route": ("H3", ("mxu2_sources_kernel", "mxu2_jump_kernel",
                          "mxu2_out_kernel")),
    "xxh32_stream": ("H4", ("xxh32_stream_kernel",)),
    "xxh32_blocks": ("H5", ("xxh32_blocks_kernel",)),
}
ENGINE_KERNELS = {"dense": ("mxu2_route",),
                  "fused": ("fused_expand", "fused_route"), "sparse": ()}
STEPS = ("parse", "scan", "plan", "stage", "engines", "verify")
SESSION_SPANS = ("submit", "result_on_device", "sync")

#: End-to-end metrics and their units.
METRICS = {"decode_gbps": "GB/s", "request_ms_p50": "ms",
           "request_ms_p75": "ms", "ops_attempted": "requests",
           "ops_failed": "requests"}
#: Per-layer metrics of the traced run and their units, per request, or
#: per round in session-mix.
LAYERS = {"parse_ms": "ms/{unit}", "scan_ms": "ms/{unit}",
          "plan_ms": "ms/{unit}", "stage_ms": "ms/{unit}",
          "verify_ms": "ms/{unit}", "engines_ms": "ms/{unit}",
          "device_busy_share": "fraction of the traced window",
          "peak_device_bytes": "B", "traced_ms": "ms/{unit}",
          "tracing_overhead_ms": "ms/{unit}"}
#: The host around the end-to-end run (:mod:`bench_torch.host`): medians
#: per request, or per round in session-mix, and the machine's CPU time
#: over the timed window.
HOST = {"host_cpu_ms": "ms/{unit}",
        "host_sys_share": "fraction of the process's CPU time",
        "host_preemptions": "switches/{unit}",
        "host_steal_share": "fraction of the machine's CPU time",
        "host_others_cpus": "CPUs"}


class BenchFailure(Exception):
    """A wrong output byte, an unexpected kernel mix, or a cell over its
    time budget."""


def percentile(samples, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``samples``; refused
    (``ValueError``) unless at least ten samples lie beyond it."""
    xs = sorted(samples)
    rank = max(1, math.ceil(q / 100 * len(xs)))
    if len(xs) - rank < 10:
        raise ValueError(f"p{q:g} of {len(xs)} samples has "
                         f"{len(xs) - rank} beyond it; it needs 10")
    return xs[rank - 1]


def metric(value, unit: str, **extra) -> dict:
    return {"value": value, "unit": unit, **extra}


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


@contextlib.contextmanager
def fallback_refused():
    """Within: ``decompress_to_device``'s fallback to the host engine
    (taken on any Lz4Error, a wrong device result under a content
    checksum among them) fails the bench, so every byte comes from the
    card."""
    real = api.decompress_host

    def refuse(data, reservation=None):
        raise BenchFailure("a sound frame fell back to decompress_host")

    api.decompress_host = refuse
    try:
        yield
    finally:
        api.decompress_host = real


class _Deadline:
    def __init__(self, cell: str):
        self.cell = cell
        self.at = time.perf_counter() + CELL_BUDGET_S

    def check(self) -> None:
        if time.perf_counter() > self.at:
            raise BenchFailure(f"{self.cell}: over its budget of "
                               f"{CELL_BUDGET_S:g} s")


def _compare(out: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    if out.shape != ref.shape:
        raise BenchFailure(f"{what}: {tuple(out.shape)} bytes out, "
                           f"{ref.shape[0]} expected")
    if not torch.equal(out, ref):
        first = int((out != ref).nonzero()[0, 0])
        raise BenchFailure(f"{what}: differs from the original first at "
                           f"byte {first}")


def _decode(r, dev):
    return lt.decompress_to_device(r.comp, device=dev, verify="device")


def expected_kernels(requests, mixes) -> set:
    """The kernels a cell's requests launch: their engines' kernels, the
    block fill of zeros, and H4 for the content checksum."""
    want = {"xxh32_stream"}
    for r, mix in zip(requests, mixes):
        for engine in mix:
            want.update(ENGINE_KERNELS[engine])
        if r.kind == "zeros":
            want.add("block_fill")
    return want


# ---------------------------------------------------------------------------
# end to end (untraced)
# ---------------------------------------------------------------------------

def run_single(cell, requests, refs, dev, deadline, timed=TIMED) -> dict:
    """Closed loop, one client: ``timed`` requests, the distinct ones in
    turn, each timed from the call to a synchronise."""
    t0 = time.perf_counter()
    for _ in range(WARMUP_PASSES):
        for i, r in enumerate(requests):
            out = _decode(r, dev)
            _sync(dev)
            _compare(out, refs[i], f"{cell.name} warm-up request {i}")
            deadline.check()
    warmup_s = time.perf_counter() - t0
    _kernels.reset_launches()
    lat, cpu, switches = [], [], []
    n_bytes, failed, first = 0, 0, None
    window = host.Window()
    window.start()
    for j in range(timed):
        i = j % len(requests)
        p0 = host.process()
        s = time.perf_counter()
        try:
            out = _decode(requests[i], dev)
            _sync(dev)
            lat.append(time.perf_counter() - s)
            p1 = host.process()
            cpu.append((p1[0] - p0[0], p1[1] - p0[1]))
            switches.append(p1[2] - p0[2])
            n_bytes += len(requests[i].orig)
            _compare(out, refs[i], f"{cell.name} request {j}")
        except (BenchFailure, lt.Lz4Error, RuntimeError, ValueError) as e:
            failed += 1
            first = first or e
        out = None
        deadline.check()
    window.stop()
    if failed:
        raise BenchFailure(f"{cell.name}: {failed} of {timed} requests "
                           f"failed; the first: {first}")
    return dict(warmup_s=warmup_s, lat=lat, gbps=n_bytes / sum(lat) / 1e9,
                attempted=timed, launches=dict(_kernels.LAUNCHES),
                per=timed, cpu=cpu, switches=switches, window=window)


def _session_round(session, requests, dev, lat, spans=False):
    """One closed-loop round with ``SESSION_INFLIGHT`` in flight: the
    round's seconds and its outputs in request order."""
    outs = [None] * len(requests)
    pending = collections.deque()
    span = record_function if spans else (lambda _n: contextlib.nullcontext())

    def collect():
        i, t_sub, ticket = pending.popleft()
        with span("result_on_device"):
            out = ticket.result_on_device(verify="device")
        with span("sync"):
            _sync(dev)
        lat.append(time.perf_counter() - t_sub)
        outs[i] = out

    t0 = time.perf_counter()
    for i, r in enumerate(requests):
        if len(pending) == SESSION_INFLIGHT:
            collect()
        t_sub = time.perf_counter()
        with span("submit"):
            pending.append((i, t_sub, session.submit(r.comp)))
    while pending:
        collect()
    return time.perf_counter() - t0, outs


def run_session(cell, requests, refs, dev, deadline, session) -> dict:
    def checked_round(label, lat):
        p0 = host.process()
        round_s, outs = _session_round(session, requests, dev, lat)
        p1 = host.process()
        cpu.append((p1[0] - p0[0], p1[1] - p0[1]))
        switches.append(p1[2] - p0[2])
        failed = []
        for i, out in enumerate(outs):
            try:
                _compare(out, refs[i], f"{cell.name} {label} request {i}")
            except BenchFailure as e:
                failed.append(e)
        if failed:
            raise BenchFailure(f"{cell.name}: {len(failed)} of "
                               f"{len(outs)} requests failed; the first: "
                               f"{failed[0]}")
        deadline.check()
        return round_s

    cpu, switches = [], []
    t0 = time.perf_counter()
    checked_round("warm-up", [])
    warmup_s = time.perf_counter() - t0
    _kernels.reset_launches()
    del cpu[:], switches[:]
    lat, rounds_s = [], []
    n_bytes = sum(len(r.orig) for r in requests)
    window = host.Window()
    window.start()
    for k in range(SESSION_ROUNDS):
        rounds_s.append(checked_round(f"round {k}", lat))
    window.stop()
    # all the rounds' bytes over all their time: a round that stalls
    # moves the rate
    return dict(warmup_s=warmup_s, lat=lat,
                gbps=SESSION_ROUNDS * n_bytes / sum(rounds_s) / 1e9,
                attempted=len(lat), launches=dict(_kernels.LAUNCHES),
                per=SESSION_ROUNDS, rounds_s=rounds_s,
                rounds_gbps=[n_bytes / s / 1e9 for s in rounds_s],
                cpu=cpu, switches=switches, window=window)


# ---------------------------------------------------------------------------
# traced
# ---------------------------------------------------------------------------

def replay(r, dev) -> tuple:
    """One pass of ``decompress_to_device(verify="device")``'s steps,
    each in a span and followed by a synchronise: (the output, host ms a
    step, engines ms by CUDA events or None)."""
    data = r.comp
    ms = {}

    def step(name, fn):
        with record_function(name):
            s = time.perf_counter()
            out = fn()
            _sync(dev)
            ms[name] = 1e3 * (time.perf_counter() - s)
        return out

    buf = np.frombuffer(data, np.uint8)
    parsed = step("parse", lambda: pl.parse_frames(buf, lt.FOR_ALL))
    table = step("scan", lambda: pl.build_seq_table(
        buf, parsed, lt.FOR_ALL, data, pooled_cols=True))
    plan = step("plan", lambda: pl.plan_decode(buf, parsed, table))
    bsums = any(b.checksum is not None
                for f in parsed.frames for b in f.blocks)
    # the compressed bytes go to the card once where a sparse program
    # copies from them or block checksums hash them
    comp_dev = step("stage", lambda: to_device(buf, dev)
                    if plan.sparse or plan.other or bsums else None)
    ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
          if dev.type == "cuda" else None)

    def engines():
        if ev:
            ev[0].record()
        segs = pl.build_device_segments(buf, table, plan, dev,
                                        comp_dev=comp_dev)
        out = pl.assemble_device_segments(segs, table.n_out, dev)
        if ev:
            ev[1].record()
        return out

    out = step("engines", engines)
    step("verify", lambda: pl._verify_checksums_device(
        buf, parsed, out, table, comp_dev=comp_dev if bsums else None))
    return out, ms, (ev[0].elapsed_time(ev[1]) if ev else None)


def _merge(intervals):
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def profile_events(prof, names) -> tuple:
    """A profile's device operations, and its CPU events named in
    ``names`` (the bench's spans), as ``(start us, end us, name)``.  The
    spans' own marks on the device timeline are not operations."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    dev, spans = [], []
    for e in prof.events():
        row = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == cpu and e.name in names:
            spans.append(row)
        elif (e.device_type == cuda and row[1] > row[0]
              and e.name not in names
              and not getattr(e, "is_user_annotation", False)):
            dev.append(row)
    return dev, spans


def device_profile(dev_ev, spans, window_span: str, units: int) -> dict:
    """Busy share, kernel ms per unit, the top device operations and the
    longest idle gaps of the traced window (the ``window_span`` spans:
    the bench's own work between them, its comparisons, stays out),
    each under the bench span it fell in.  Every field is "not
    measured" where there is no device event."""
    out = {"busy": NOT_MEASURED, "kernel_ms": {}, "top_ops": NOT_MEASURED,
           "idle_gaps": NOT_MEASURED}
    windows = _merge((lo, hi) for lo, hi, n in spans if n == window_span)
    inside = [(lo, hi, n) for lo, hi, n in dev_ev
              if any(lo < w_hi and hi > w_lo for w_lo, w_hi in windows)]
    if not inside:
        return out
    inner = [s for s in spans if s[2] != window_span]

    def open_span(lo, hi):
        """The span that overlaps [lo, hi] most (an operation or a gap
        is placed by its extent, not by its start: the device's and the
        host's clocks agree to a few microseconds, not to zero)."""
        best, name = 0.0, "-"
        for s_lo, s_hi, s_name in inner:
            overlap = min(hi, s_hi) - max(lo, s_lo)
            if overlap > best:
                best, name = overlap, s_name
        return name

    gaps, busy_us = [], 0.0
    for w_lo, w_hi in windows:
        busy = _merge((max(lo, w_lo), min(hi, w_hi)) for lo, hi, _n in inside
                      if lo < w_hi and hi > w_lo)
        busy_us += sum(hi - lo for lo, hi in busy)
        edges = [w_lo] + [x for b in busy for x in b] + [w_hi]
        gaps += [(hi - lo, lo, hi) for lo, hi in zip(edges[0::2], edges[1::2])
                 if hi > lo]
    out["busy"] = busy_us / sum(hi - lo for lo, hi in windows)
    for name, (_h, symbols) in KERNELS.items():
        us = sum(hi - lo for lo, hi, n in inside
                 if any(sym in n for sym in symbols))
        out["kernel_ms"][name] = us / 1e3 / units
    ops = collections.defaultdict(lambda: [0.0, 0])
    for lo, hi, name in inside:
        row = ops[(open_span(lo, hi),
                   name.replace("(anonymous namespace)::", "")[:60])]
        row[0] += (hi - lo) / 1e3
        row[1] += 1
    out["top_ops"] = [[span, name, ms, n] for (span, name), (ms, n)
                      in sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]]
    out["idle_gaps"] = [[g / 1e3, open_span(lo, hi)]
                        for g, lo, hi in sorted(gaps, reverse=True)[:TOP]]
    return out


def _profiled(prof, window_span: str, names, units: int) -> dict:
    if prof is None:                    # the CPU: no device to see
        return device_profile([], [], window_span, units)
    return device_profile(*profile_events(prof, {window_span, *names}),
                          window_span, units)


def _profiler(dev):
    """The profiler of a traced run on the card; none on the CPU, which
    has no device time to record."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def trace_replays(requests, refs, dev, deadline, passes) -> tuple:
    """``passes`` traced passes over the requests: (medians over passes
    of each step's host ms and of the engines' event ms summed over a
    pass, the profile, peak device bytes or None)."""
    sums = collections.defaultdict(list)
    base = _reset_peak(dev)
    with _profiler(dev) as prof:
        for _ in range(passes):
            tot = collections.defaultdict(float)
            for r, ref in zip(requests, refs):
                with record_function("request"):
                    out, ms, ev_ms = replay(r, dev)
                _compare(out, ref, "traced replay")
                del out                 # not held into the next request
                for k, v in ms.items():
                    tot[k] += v
                tot["traced"] += sum(ms.values())
                tot["events"] = (None if ev_ms is None
                                 else tot["events"] + ev_ms)
                deadline.check()
            for k, v in tot.items():
                sums[k].append(v)
    med = {k: (None if None in v else statistics.median(v))
           for k, v in sums.items()}
    return med, prof, _peak(dev, base)


def _reset_peak(dev) -> int:
    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak(dev, base: int) -> int | None:
    """Peak device bytes allocated above ``base`` (what the bench itself
    holds: the original bytes it compares with) since the reset."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) - base


def trace_session(session, requests, dev, deadline, rounds) -> tuple:
    base = _reset_peak(dev)
    times = []
    with _profiler(dev) as prof:
        for _ in range(rounds):
            with record_function("round"):
                s, _outs = _session_round(session, requests, dev, [],
                                          spans=True)
            times.append(s)
            deadline.check()
    return statistics.median(times), prof, _peak(dev, base)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------

def bench_cell(cell, seed: int, dev, size: int | None = None,
               timed: int = TIMED) -> dict:
    """Make the cell's inputs and run it on ``dev``: its entry in the
    JSON line.  At the cell's own size the recorded input and every
    request's engine mix are asserted first; ``size`` (a rehearsal at a
    smaller size) skips both.  ``timed`` is the number of timed requests
    of a single-request cell."""
    dev = torch.device(dev)
    deadline = _Deadline(cell.name)
    t0 = time.perf_counter()
    requests = corpora.cell_requests(cell, seed, size)
    mixes = [corpora.engine_mix(r.comp) for r in requests]
    if size is None:
        corpora.check_record(cell, seed, requests)
        corpora.check_engines(cell, requests, mixes)
    comp_bytes, sha = corpora.digest(requests)
    refs = [to_device(np.frombuffer(r.orig, np.uint8), dev)
            for r in requests]
    _sync(dev)
    prepare_s = time.perf_counter() - t0
    session = cell.name == "session-mix"
    unit = "round" if session else "request"
    if session:
        with lt.DecodeSession(max_inflight=SESSION_INFLIGHT,
                              device=dev) as s:
            e2e = run_session(cell, requests, refs, dev, deadline, s)
            hosts = trace_replays(requests, refs, dev, deadline, 1)[0]
            traced_s, prof, peak = trace_session(s, requests, dev,
                                                 deadline, TRACED_PASSES)
        e2e_unit_ms = 1e3 * statistics.mean(e2e["rounds_s"])
        traced_ms = 1e3 * traced_s
        prof_units = TRACED_PASSES
        dev_prof = _profiled(prof, "round", SESSION_SPANS, prof_units)
    else:
        e2e = run_single(cell, requests, refs, dev, deadline, timed)
        hosts, prof, peak = trace_replays(requests, refs, dev, deadline,
                                          TRACED_PASSES)
        per = len(requests)
        hosts = {k: (None if v is None else v / per)
                 for k, v in hosts.items()}
        e2e_unit_ms = 1e3 * statistics.median(e2e["lat"])
        traced_ms = hosts["traced"]
        prof_units = TRACED_PASSES * per
        dev_prof = _profiled(prof, "request", STEPS, prof_units)
    on_card = dev.type == "cuda"
    launched = {k for k, v in e2e["launches"].items() if v}
    want = expected_kernels(requests, mixes)
    if on_card and launched != want:
        raise BenchFailure(f"{cell.name}: launched {sorted(launched)}, "
                           f"expected {sorted(want)}")
    lat_ms = [1e3 * x for x in e2e["lat"]]
    # session-mix: each round's rate beside the rate of all the rounds
    extra = {"decode_gbps": ({"rounds": e2e["rounds_gbps"]} if session
                             else {"requests": e2e["attempted"]}),
             "request_ms_p50": {"samples": len(lat_ms),
                                "range": [min(lat_ms), max(lat_ms)]},
             "request_ms_p75": {"samples": len(lat_ms)}}
    ends = {"decode_gbps": e2e["gbps"],
            "request_ms_p50": percentile(lat_ms, 50),
            "request_ms_p75": percentile(lat_ms, 75),
            "ops_attempted": e2e["attempted"], "ops_failed": 0}
    layers = {f"{k}_ms": hosts[k] for k in ("parse", "scan", "plan",
                                             "stage", "verify")}
    layers.update(engines_ms=hosts["events"],
                  device_busy_share=dev_prof["busy"],
                  peak_device_bytes=peak, traced_ms=traced_ms,
                  tracing_overhead_ms=traced_ms - e2e_unit_ms)
    around = {"host_cpu_ms": 1e3 * statistics.median(
                  u + k for u, k in e2e["cpu"]),
              "host_sys_share": statistics.median(
                  k / (u + k) if u + k else 0.0 for u, k in e2e["cpu"]),
              "host_preemptions": statistics.median(e2e["switches"]),
              "host_steal_share": e2e["window"].steal_share,
              "host_others_cpus": e2e["window"].others_cpus}

    def measured(v, u):
        return metric(NOT_MEASURED if v is None else v, u.format(unit=unit))

    kernels = {}
    for name, (h, _sym) in KERNELS.items():
        kernels[name] = {
            "port": h,
            "launches": measured(e2e["launches"][name] / e2e["per"]
                                 if on_card else None, "launches/{unit}"),
            "ms": measured(dev_prof["kernel_ms"].get(name), "ms/{unit}"),
        }
    print_breakdown(cell.name, dev_prof, prof_units, unit)
    return {
        "config": cell.config,
        "traffic": cell.traffic,
        "source": cell.source,
        "input": {"requests": len(requests),
                  "decoded_bytes": sum(len(r.orig) for r in requests),
                  "comp_bytes": comp_bytes, "sha256": sha,
                  "engines": corpora.total_mix(mixes)},
        "setup": {"prepare_s": metric(prepare_s, "s"),
                  "warmup_s": metric(e2e["warmup_s"], "s")},
        "metrics": {k: metric(ends[k], u, **extra.get(k, {}))
                    for k, u in METRICS.items()},
        "layers": {k: measured(layers[k], u) for k, u in LAYERS.items()},
        "host": {k: measured(around[k], u) for k, u in HOST.items()},
        "kernels": kernels,
        "breakdown": {"top_ops": dev_prof["top_ops"],
                      "idle_gaps": dev_prof["idle_gaps"]},
    }


def print_breakdown(name, dev_prof, units, unit) -> None:
    if dev_prof["top_ops"] == NOT_MEASURED:
        print(f"[breakdown] {name}: the profiler recorded no device time; "
              "not measured", flush=True)
        return
    print(f"[breakdown] {name}: top device operations over {units} traced "
          f"{unit}s (bench span, operation, ms, count): "
          + "; ".join(f"{s} {op} {ms:.4f} x{n}"
                      for s, op, ms, n in dev_prof["top_ops"]), flush=True)
    print(f"[breakdown] {name}: longest device-idle gaps (ms, bench span "
          "open): " + "; ".join(f"{g:.4f} {s}"
                                for g, s in dev_prof["idle_gaps"]),
          flush=True)


def run(seed: int, timed: int = TIMED) -> dict:
    """Every cell on the card; the JSON line's object."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _kernels.lib()                      # nvcc at first use
    build_s = time.perf_counter() - t0
    out = {
        "bench": "bench_torch",
        "seed": seed,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "setup": {"build_s": metric(build_s, "s")},
        "host_threads": metric(native.pack_threads(), "threads"),
        "host": host.machine(),
        "timed": timed,
        "cells": {},
    }
    with fallback_refused():
        for cell in corpora.CELLS:
            out["cells"][cell.name] = bench_cell(cell, seed, dev,
                                                 timed=timed)
            torch.cuda.empty_cache()
    return out


__all__ = ["BenchFailure", "bench_cell", "percentile", "run"]
