"""Arithmetic the metric readers under ``metrics/`` share.

An end-to-end reader's ``read(window)`` takes a :class:`harness.Window`;
a per-layer reader's ``read(trace)`` a :class:`tracing.Trace`.  A reader
that finds nothing to read returns None, and the metric is left out of
the result's line; a share of a peak is never made up as 0.
"""

from __future__ import annotations

import json
import pathlib

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent
                    / "peaks.json").read_text())


def rate_gbps(window) -> float | None:
    """Bytes of input served over the whole window (failed requests
    serve none), in GB/s."""
    if not window.lat or window.seconds <= 0:
        return None
    return sum(window.raw) / window.seconds / 1e9


def span_ms(trace, name: str) -> float | None:
    """Host ms a traced request spent in span ``name``, the mean over the
    traced requests; None where no request recorded it."""
    got = [r.spans[name] for r in trace.requests if name in r.spans]
    if not got:
        return None
    return 1e3 * sum(got) / len(trace.requests)


def host_cpu_ms(trace) -> float | None:
    if not trace.requests:
        return None
    return 1e3 * sum(r.cpu_s for r in trace.requests) / len(trace.requests)


def roofline(trace) -> float | None:
    """The bytes the traced requests need, the input read once and the
    output written once (compressed and decoded bytes, whichever way
    round), at the card's peak bandwidth, over the summed time of the
    device operations inside the requests: a share in %."""
    peak = PEAKS.get(trace.device_kind, {}).get("hbm_bytes_per_s")
    times = [r.device_s for r in trace.requests]
    if peak is None or not times or None in times or sum(times) <= 0:
        return None
    need = sum(r.raw + r.comp for r in trace.requests) / peak
    return 100.0 * need / sum(times)


def idle_share(trace) -> float | None:
    if not trace.window_s or trace.busy_s is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def ratio(trace) -> float | None:
    raw = sum(r.raw for r in trace.requests if r.comp)
    if not raw:
        return None
    return 100.0 * sum(r.comp for r in trace.requests) / raw
