"""The traced run: spans around the program's layers, the profiler's
device timeline, and what the per-layer readers read.

Each file under ``spans/`` names a function of the program (module and
attribute) and the span it gets.  For the traced run only, the function
is replaced in its module by a wrapper that records a
``torch.profiler.record_function`` span of that name and the host
seconds inside it, ending in a synchronise where the file says so.  The
program's own files are not touched; a function the program no longer
has records nothing.  The spans are the benchmark's, around the calls
into each layer; spans inside the program are for a later change.

The traced requests run closed loop, one client, as in the window, each
inside a ``lz4bench.request`` span; the traced window is those spans
laid end to end.  Device time is read from the profiler: its CUDA
events, the spans' own marks left out.  Where the profiler records no
device event, the device readings are None ("not measured").
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import importlib
import json
import pathlib
import time

from . import harness

SPANS_DIR = pathlib.Path(__file__).resolve().parent / "spans"
REQUEST_SPAN = "lz4bench.request"
CHECK_SPAN = "lz4bench.check"     # the benchmark's own work on an answer
TOP = 10


@dataclasses.dataclass
class TracedRequest:
    raw: int                 # B of input a request's bytes came from
    comp: int                # B of the frame
    seconds: float           # host clock, call to a synchronise
    cpu_s: float             # process CPU seconds, every thread's
    spans: dict              # span name -> host seconds inside it
    device_s: float | None = None   # summed device operations inside it


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read."""
    entry: str
    device_kind: str
    requests: list = dataclasses.field(default_factory=list)
    failed: int = 0
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None
    plans: list = dataclasses.field(default_factory=list)


class _Recorder:
    def __init__(self):
        self.spans = collections.defaultdict(float)
        self.plans = []


def span_files(spans_dir: pathlib.Path = SPANS_DIR) -> dict:
    return {p.name[:-len(".json")]: json.loads(p.read_text())
            for p in sorted(spans_dir.glob("*.json"))}


@contextlib.contextmanager
def wrapped(rec: _Recorder, entry, dev, spans_dir=SPANS_DIR):
    """Within: each span file's function wrapped in its span."""
    import torch
    from torch.profiler import record_function

    undo = []

    def wrap(name, fn, sync):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(name):
                t = time.perf_counter()
                try:
                    out = fn(*args, **kwargs)
                    if sync and dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                finally:
                    rec.spans[name] += time.perf_counter() - t
            if name == "plan" and hasattr(entry, "describe_plan"):
                rec.plans.append(entry.describe_plan(out))
            return out
        return inner

    try:
        for name, spec in span_files(spans_dir).items():
            try:
                mod = importlib.import_module(spec["module"])
                fn = getattr(mod, spec["attr"])
            except (ImportError, AttributeError):
                harness.log(f"span {name}: {spec['module']}."
                            f"{spec['attr']} is gone; not recorded")
                continue
            setattr(mod, spec["attr"], wrap(name, fn, spec["sync"]))
            undo.append((mod, spec["attr"], fn))
        yield
    finally:
        for mod, attr, fn in reversed(undo):
            setattr(mod, attr, fn)


def _profiler(dev):
    if dev.type != "cuda":
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def traced_run(entry, cell, dev) -> Trace:
    import torch
    from torch.profiler import record_function

    rec = _Recorder()
    tr = Trace(cell.traffic["entry"], torch.cuda.get_device_name(dev)
               if dev.type == "cuda" else "cpu")
    n_distinct = len(entry.requests)
    with wrapped(rec, entry, dev), _profiler(dev) as prof:
        for i in range(cell.traffic["traced_requests"]):
            k = i % n_distinct
            rec.spans.clear()
            c0 = sum(harness.cpu_times())
            s = time.perf_counter()
            with record_function(REQUEST_SPAN):
                try:
                    answer = entry.call(k)
                    entry.sync()
                except Exception as e:
                    answer = None
                    tr.failed += 1
                    entry.note_failure(k, e)
            seconds = time.perf_counter() - s
            tr.requests.append(TracedRequest(
                entry.raw_bytes(k), entry.comp_bytes(k, answer), seconds,
                sum(harness.cpu_times()) - c0, dict(rec.spans)))
            # the check's device work ends before the next request
            with record_function(CHECK_SPAN):
                if answer is not None:
                    entry.keep(k, answer)
                    entry.sync()
                del answer
    tr.plans = rec.plans
    if prof is not None:
        _read_profile(prof, tr, set(span_files()) | {CHECK_SPAN})
    return tr


def _merge(intervals) -> list:
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _read_profile(prof, tr: Trace, span_names: set) -> None:
    """Busy and window seconds, device seconds a request, and the
    breakdown, from the profiler's events (microseconds).  The traced
    window is the requests' spans laid end to end: the benchmark's own
    work between them (its check of each answer) stays out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ours = span_names | {REQUEST_SPAN}
    ops, requests, spans = [], [], []
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if (hi > lo and e.name not in ours
                    and not getattr(e, "is_user_annotation", False)):
                ops.append((lo, hi, e.name))
        elif e.name == REQUEST_SPAN:
            requests.append((lo, hi))
        elif e.name in span_names:
            spans.append((lo, hi, e.name))
    requests.sort()
    # each operation clipped to the request it ran in
    inside = [(max(lo, r_lo), min(hi, r_hi), n) for r_lo, r_hi in requests
              for lo, hi, n in ops if lo < r_hi and hi > r_lo]
    if not inside:
        harness.log("the profiler recorded no device operation: device "
                    "readings not measured")
        return
    busy = _merge((lo, hi) for lo, hi, _n in inside)
    tr.busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    tr.window_s = sum(hi - lo for lo, hi in requests) / 1e6
    for req, (r_lo, r_hi) in zip(tr.requests, requests):
        req.device_s = sum(hi - lo for lo, hi, _n in inside
                           if lo >= r_lo and hi <= r_hi) / 1e6

    def open_span(lo, hi):
        """The benchmark span that overlaps [lo, hi] most, the innermost
        (shortest) among equals; the request itself where none does."""
        best = (0.0, 0.0, REQUEST_SPAN)
        for s_lo, s_hi, name in spans:
            overlap = min(hi, s_hi) - max(lo, s_lo)
            if overlap > 0 and (overlap, -(s_hi - s_lo)) > best[:2]:
                best = (overlap, -(s_hi - s_lo), name)
        return best[2]

    by_name = collections.defaultdict(float)
    for lo, hi, name in inside:
        by_name[name] += (hi - lo) / 1e6
    gaps = []
    for r_lo, r_hi in requests:
        edges = [r_lo] + [x for b in busy if b[0] < r_hi and b[1] > r_lo
                          for x in (max(b[0], r_lo), min(b[1], r_hi))]
        edges.append(r_hi)
        gaps += [(hi - lo, lo, hi) for lo, hi in zip(edges[0::2],
                                                     edges[1::2]) if hi > lo]
    gaps = sorted(gaps, reverse=True)[:TOP]
    tr.breakdown = {
        "device_ops": [[n, s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[open_span(lo, hi), g / 1e6] for g, lo, hi in gaps],
    }
