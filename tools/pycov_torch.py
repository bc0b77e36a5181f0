"""Line and branch coverage of lz4tpu_torch: ``tools/pycov.py`` pointed
at the port, with hit sets that are saved, merged across runs and
machines, and reported with the lines that only a card reaches apart.

``tools/pycov.py`` is reused by import, not edited: its ``sys.monitoring``
callbacks read ``pycov.PKG`` at call time, so setting it to the port's
directory (with a trailing separator, so ``lz4tpu/`` is not matched)
records the port's lines and branch directions.  Its report walks and
writes the JAX package's tree, so this tool writes its own.

Two steps::

    # record: pytest arguments, or a script run by runpy; the run's hits
    # are merged into FILE (created if missing; one writer at a time)
    python tools/pycov_torch.py run --hits FILE.json [PYTEST ARGS...]
    python tools/pycov_torch.py run --hits FILE.json --script chip_smoke.py

    # report: the CPU hit sets against the card's; a "## Notes" section
    # at the end of the file it replaces is kept
    python tools/pycov_torch.py report --cpu A.json [--cpu B.json ...] \\
        [--card C.json ...] [--out COVERAGE_TORCH.md]

A hit set holds, per file of the port (relative to the repository), its
lines and, per branch site (the code object's qualified name and first
line, and the branch instruction's offset), the destinations taken.
Offsets are the interpreter's bytecode, so the hit sets of one report
must come from one minor version of Python.  ``sys.monitoring`` sees
only its own process: subprocesses (the two-process gloo workers, the
CLI runs, the smoke's installed-tree process) are not counted.
"""

from __future__ import annotations

import argparse
import dis
import json
import os
import runpy
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import pycov  # noqa: E402  (tools/pycov.py; it puts the repository on sys.path)

REPO = pycov.REPO
PORT = os.path.join(REPO, "lz4tpu_torch")
DEFAULT_TESTS = "tests/test_torch_*.py"
#: The report's hand-written section: ``report`` keeps it from the file
#: it overwrites (notes on branches that have no test).
NOTES = "## Notes"

_codes: dict[int, object] = {}      # id -> code, kept alive: ids stay unique


def _on_branch(code, src, dst):
    _codes[id(code)] = code
    return pycov._on_branch(code, src, dst)


def port_files() -> list[str]:
    """The port's ``.py`` files, as paths relative to the repository."""
    out = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in sorted(files) if f.endswith(".py")]
    return out


def _site(code, src) -> str:
    return f"{code.co_qualname}:{code.co_firstlineno}:{src}"


def possible_sites(rel: str) -> dict[str, int]:
    """Branch site -> source line, for every conditional branch of the
    file's compiled code (two outcomes each, as ``pycov`` counts)."""
    sites = {}
    for code in pycov._walk_codes(os.path.join(REPO, rel)):
        for ins in dis.get_instructions(code):
            if ins.opname in pycov._BRANCH_OPS:
                sites[_site(code, ins.offset)] = (
                    ins.positions.lineno if ins.positions else 0) or 0
    return sites


def record(argv: list[str], script: str | None) -> int:
    """Run pytest on ``argv`` (or ``script`` with ``argv`` as its
    arguments) under the monitor; returns its exit code."""
    pycov.PKG = PORT + os.sep
    mon = sys.monitoring
    mon.use_tool_id(pycov.TOOL, "pycov_torch")
    mon.register_callback(pycov.TOOL, mon.events.LINE, pycov._on_line)
    mon.register_callback(pycov.TOOL, mon.events.BRANCH, _on_branch)
    mon.set_events(pycov.TOOL, mon.events.LINE | mon.events.BRANCH)
    try:
        if script:
            sys.argv = [script, *argv]
            sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
            try:
                runpy.run_path(script, run_name="__main__")
                rc = 0
            except SystemExit as e:
                rc = e.code if isinstance(e.code, int) else (e.code is not None)
        else:
            import pytest

            rc = int(pytest.main(argv or _default_tests()))
    finally:
        mon.set_events(pycov.TOOL, 0)
        mon.free_tool_id(pycov.TOOL)
    return rc


def _default_tests() -> list[str]:
    import glob

    return sorted(glob.glob(os.path.join(REPO, DEFAULT_TESTS))) + ["-q"]


def hits_of_run() -> dict:
    """This process's hits in the saved form."""
    out: dict = {}
    for fn, lines in pycov.hit.items():
        rel = os.path.relpath(fn, REPO)
        out.setdefault(rel, {"lines": set(), "branches": {}})["lines"] |= lines
    for (fn, cid, src), dests in pycov.bsites.items():
        rel = os.path.relpath(fn, REPO)
        entry = out.setdefault(rel, {"lines": set(), "branches": {}})
        entry["branches"].setdefault(_site(_codes[cid], src),
                                     set()).update(dests)
    return out


def load(path: str) -> dict:
    with open(path) as f:
        raw = json.load(f)
    return {rel: {"lines": set(e["lines"]),
                  "branches": {k: set(v) for k, v in e["branches"].items()}}
            for rel, e in raw.items()}


def merge(*sets: dict) -> dict:
    out: dict = {}
    for s in sets:
        for rel, e in s.items():
            m = out.setdefault(rel, {"lines": set(), "branches": {}})
            m["lines"] |= e["lines"]
            for k, v in e["branches"].items():
                m["branches"].setdefault(k, set()).update(v)
    return out


def save(path: str, hits: dict) -> None:
    raw = {rel: {"lines": sorted(e["lines"]),
                 "branches": {k: sorted(v)
                              for k, v in sorted(e["branches"].items())}}
           for rel, e in sorted(hits.items())}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(raw, f, separators=(",", ":"))
    os.replace(tmp, path)


def ranges(lines) -> str:
    """``[1, 2, 3, 7]`` -> ``"1-3, 7"``."""
    out, run = [], []
    for n in sorted(lines):
        if run and n == run[-1] + 1:
            run.append(n)
        else:
            if run:
                out.append(_span(run))
            run = [n]
    if run:
        out.append(_span(run))
    return ", ".join(out)


def _span(run) -> str:
    return str(run[0]) if len(run) == 1 else f"{run[0]}-{run[-1]}"


def file_rows(cpu: dict, card: dict) -> list[dict]:
    """Per file of the port: its possible lines and branch outcomes, and
    those the CPU run took, those only the card took, and those neither
    took."""
    rows = []
    empty = {"lines": set(), "branches": {}}
    for rel in port_files():
        poss = pycov._possible_lines(os.path.join(REPO, rel))
        c, g = cpu.get(rel, empty), card.get(rel, empty)
        l_cpu = c["lines"] & poss
        l_card = (g["lines"] & poss) - l_cpu
        sites = possible_sites(rel)
        b_cpu = b_card = 0
        partial = set()
        for site, line in sites.items():
            n_cpu = min(len(c["branches"].get(site, ())), 2)
            n_all = min(len(c["branches"].get(site, set())
                            | g["branches"].get(site, set())), 2)
            b_cpu += n_cpu
            b_card += n_all - n_cpu
            if n_all < 2:
                partial.add(line)
        rows.append({"file": rel, "lines": len(poss), "l_cpu": len(l_cpu),
                     "l_card": sorted(l_card),
                     "l_missed": sorted(poss - l_cpu - l_card),
                     "branches": 2 * len(sites), "b_cpu": b_cpu,
                     "b_card": b_card, "b_partial": sorted(partial)})
    return rows


def _pct(a: int, b: int) -> str:
    return f"{100.0 * a / b:.1f}" if b else "100.0"


def _count(v) -> int:
    """A row's count, or the length of its list of lines."""
    return v if isinstance(v, int) else len(v)


def report(rows: list[dict], cpu_paths, card_paths) -> str:
    tot = {k: sum(_count(r[k]) for r in rows)
           for k in ("lines", "l_cpu", "l_card", "l_missed", "branches",
                     "b_cpu", "b_card")}
    out = [
        "# Line + branch coverage of lz4tpu_torch (tools/pycov_torch.py)",
        "",
        "Generated by `python tools/pycov_torch.py report` from the hit "
        f"sets {', '.join(f'`{os.path.basename(p)}`' for p in cpu_paths)}"
        " (the CPU)" + (
            f" and {', '.join(f'`{os.path.basename(p)}`' for p in card_paths)}"
            " (the card)" if card_paths else "") + ".  `sys.monitoring` "
        "sees only the process it runs in: the two-process gloo workers, "
        "the CLI and console-script runs and the smoke's installed-tree "
        "process are not counted.  *Card only*: reached on the card and "
        "by no CPU run (the kernel launches and CUDA branches); they are "
        "not counted as missed.  Line % and branch % count the CPU and "
        "the card together.",
        "",
        "| file | lines | CPU | card only | missed | line % | branches "
        "| CPU | card only | branch % |",
        "|---|---:|---:|---:|---:|---:|---:|---:|---:|---:|"]
    for r in rows + [dict(tot, file="**total**")]:
        n_card, n_miss = _count(r["l_card"]), _count(r["l_missed"])
        out.append(
            f"| {r['file']} | {r['lines']} | {r['l_cpu']} | {n_card} "
            f"| {n_miss} | {_pct(r['l_cpu'] + n_card, r['lines'])} "
            f"| {r['branches']} | {r['b_cpu']} | {r['b_card']} "
            f"| {_pct(r['b_cpu'] + r['b_card'], r['branches'])} |")
    out += ["", "## Lines reached only on the card", ""]
    out += [f"- `{r['file']}`: {ranges(r['l_card'])}"
            for r in rows if r["l_card"]] or ["- none"]
    out += ["", "## Lines missed by both", ""]
    out += [f"- `{r['file']}`: {ranges(r['l_missed'])}"
            for r in rows if r["l_missed"]] or ["- none"]
    out += ["", "## Lines of branch sites not taken both ways", ""]
    out += [f"- `{r['file']}`: {ranges(r['b_partial'])}"
            for r in rows if r["b_partial"]] or ["- none"]
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pycov_torch", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="record hits of pytest or a script",
                         allow_abbrev=False)
    run.add_argument("--hits", required=True,
                     help="JSON hit set to merge this run's hits into")
    run.add_argument("--script", help="run this file by runpy, not pytest")
    rep = sub.add_parser("report", help="write the report",
                         allow_abbrev=False)
    rep.add_argument("--cpu", action="append", required=True,
                     help="hit set of a CPU run (repeatable)")
    rep.add_argument("--card", action="append", default=[],
                     help="hit set of a run on the card (repeatable)")
    rep.add_argument("--out", default=os.path.join(REPO, "COVERAGE_TORCH.md"))
    args, rest = ap.parse_known_args(argv)
    if args.cmd == "run":
        rc = record(rest, args.script)
        hits = hits_of_run()
        if os.path.exists(args.hits):
            hits = merge(load(args.hits), hits)
        save(args.hits, hits)
        n = sum(len(e["lines"]) for e in hits.values())
        print(f"pycov_torch: rc {rc}; {n} lines of {len(hits)} files in "
              f"{args.hits}", file=sys.stderr)
        return rc
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    cpu = merge(*map(load, args.cpu))
    card = merge(*map(load, args.card))
    text = report(file_rows(cpu, card), args.cpu, args.card)
    if os.path.exists(args.out):
        with open(args.out) as f:
            kept = f.read().partition(NOTES)
        if kept[1]:                 # the hand-written notes stay
            text += "\n" + NOTES + kept[2]
    with open(args.out, "w") as f:
        f.write(text)
    print(text.split("\n## ")[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
