"""``python -m bench_torch.spread OUT...``: each metric's spread over
runs of the bench, and the regression bound it sets.

Each OUT is the standard output of one ``python -m bench_torch`` run;
its last line is the run's JSON line.  For every cell and end-to-end
metric this prints the median, the quartiles and the range over the
runs, and the bound: twice the interquartile range over the median,
and never below 5%.  The per-layer metrics, the host's readings, and
each kernel's launches and ms where it launched, get their median and
range.  Last, for each cell, how the runs' ``request_ms_p50`` goes with
each host reading and each host stage across the runs (Pearson's r):
what moves a host-bound cell from one process to the next.
"""

from __future__ import annotations

import json
import statistics
import sys

from .run import HOST, LAYERS, METRICS

FLOOR = 0.05


def last_json(path: str) -> dict:
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def bound(values) -> float:
    """2 x IQR / median, at least ``FLOOR``."""
    q1, med, q3 = statistics.quantiles(values, n=4, method="inclusive")
    return max(FLOOR, 2 * (q3 - q1) / med) if med else FLOOR


def _get(cell: dict, group: str, name: str, unit: str) -> dict:
    """A reading of one run; "not measured" where that run's bench did
    not have it yet."""
    return cell.get(group, {}).get(name) or {"value": "not measured",
                                              "unit": unit}


def _row(entries) -> dict:
    vals = [e["value"] for e in entries]
    if any(isinstance(v, str) for v in vals):
        return {"unit": entries[0]["unit"], "median": "not measured"}
    q1, med, q3 = statistics.quantiles(vals, n=4, method="inclusive")
    return {"unit": entries[0]["unit"], "median": med, "q1": q1, "q3": q3,
            "min": min(vals), "max": max(vals)}


def spread(runs) -> dict:
    """cell -> metric -> {median, q1, q3, min, max, unit, bound?}; a
    kernel that launched in the cell adds ``<kernel>_launches`` and
    ``<kernel>_ms``."""
    out = {}
    for cell in runs[0]["cells"]:
        rows = {}
        for group, names in (("metrics", METRICS), ("layers", LAYERS),
                             ("host", HOST)):
            for name, unit in names.items():
                rows[name] = _row([_get(r["cells"][cell], group, name, unit)
                                   for r in runs])
                if group == "metrics" and not name.startswith("ops_"):
                    rows[name]["bound"] = bound(
                        [r["cells"][cell][group][name]["value"]
                         for r in runs])
        for kernel, k in runs[0]["cells"][cell].get("kernels", {}).items():
            if k["launches"]["value"] in (0, "not measured"):
                continue
            for what in ("launches", "ms"):
                rows[f"{kernel}_{what}"] = _row(
                    [r["cells"][cell]["kernels"][kernel][what]
                     for r in runs])
        out[cell] = rows
    return out


#: What request_ms_p50 is read against: (group, name).
AGAINST = (("host", "host_cpu_ms"), ("host", "host_sys_share"),
           ("host", "host_preemptions"),
           ("host", "host_steal_share"), ("host", "host_others_cpus"),
           ("layers", "scan_ms"), ("layers", "plan_ms"))


def correlate(runs) -> dict:
    """cell -> reading -> Pearson's r of the runs' request_ms_p50 with
    it; None where either does not vary or was not measured."""
    out = {}
    for cell in runs[0]["cells"]:
        p50 = [r["cells"][cell]["metrics"]["request_ms_p50"]["value"]
               for r in runs]
        out[cell] = {}
        for group, name in AGAINST:
            xs = [_get(r["cells"][cell], group, name, "")["value"]
                  for r in runs]
            try:
                out[cell][name] = statistics.correlation(p50, xs)
            except (statistics.StatisticsError, TypeError):
                out[cell][name] = None
    return out


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    runs = [last_json(p) for p in paths]
    if len(runs) < 2:
        print("spread: give the output of at least two runs",
              file=sys.stderr)
        return 2
    table = spread(runs)
    print(f"{len(runs)} runs; card {runs[0]['device']['kind']}; "
          f"host threads {[r['host_threads']['value'] for r in runs]}; "
          f"host {runs[0].get('host')}")
    for cell, rows in table.items():
        for name, row in rows.items():
            if isinstance(row["median"], str):
                print(f"{cell} {name}: not measured")
                continue
            line = (f"{cell} {name} ({row['unit']}): median "
                    f"{row['median']!r}, quartiles {row['q1']!r} .. "
                    f"{row['q3']!r}, range {row['min']!r} .. "
                    f"{row['max']!r}")
            if "bound" in row:
                line += f", bound {100 * row['bound']:.2f}%"
            print(line)
    corr = correlate(runs)
    for cell, rs in corr.items():
        print(f"{cell} request_ms_p50 across runs, Pearson's r with: "
              + ", ".join(f"{k} {'-' if v is None else f'{v:+.2f}'}"
                          for k, v in rs.items()))
    print(json.dumps({"runs": len(runs), "cells": table,
                      "p50_correlation": corr}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
