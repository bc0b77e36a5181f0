"""One run of one cell: set-up, the measured window or the traced run,
the check of every answer, and the result's line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (a file under ``configs/``, named in ``configs``) and a
traffic mix (``traffic/<name>.json``).  The traffic names its requests
(a corpus generator under ``corpora/`` by name, a size and a stream of
the seed), the entry point that serves them (``entries/<entry>.py``),
and how many requests the traced run traces.  End-to-end and per-layer
metrics are read by files of their own under ``metrics/``, found by the
metric's name; the spans a traced run records are files under
``spans/``.  So a configuration, a traffic mix, a corpus, a span or a
metric is added by adding files.

Closed loop, one client: the next request is sent when the last one's
answer is back.  A request is timed on the host clock from the entry's
call to a synchronise after it returns.  Every answer is checked after
the window closes (:meth:`Entry.judge`).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import resource
import sys
import time
import traceback
import zlib

import numpy as np

from . import encoder

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that nothing the benchmark runs may load: the
#: JAX stack, the JAX package, and the program's older bench and scripts.
FORBIDDEN = ("jax", "jaxlib", "flax", "lz4tpu", "bench_torch", "chip_smoke",
             "kernel_times")
WARMUP_PASSES = 2


def program_environment() -> None:
    """Before the program is imported: its own settings at their defaults
    (every ``LZ4TPU_*`` variable cleared), and its kernel cache in
    ``lz4bench/_build/kernels``, a fixed directory of the checkout, so
    that only a checkout's first run builds."""
    for key in [k for k in os.environ if k.startswith("LZ4TPU_")]:
        del os.environ[key]
    os.environ["LZ4TPU_TORCH_BUILD"] = str(HERE / "_build" / "kernels")


class BenchError(Exception):
    """The cell cannot be run as asked (a missing file, no card)."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list         # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: dict | None = None, root: pathlib.Path = ROOT,
              traffic_dir: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (``root/BENCHMARK.json`` by
    default), with its configuration and traffic read from their files."""
    if bench is None:
        bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                         f"(it has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic_dir = traffic_dir or HERE / "traffic"
    traffic = json.loads((traffic_dir / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layers)


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------

def _load_file(path: pathlib.Path, what: str):
    if not path.exists():
        raise BenchError(f"no {what} file {path.relative_to(ROOT)}"
                         if path.is_relative_to(ROOT) else f"no {what} "
                         f"file {path}")
    mod_name = "lz4bench._found." + path.stem.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def corpus(name: str):
    return _load_file(HERE / "corpora" / f"{name}.py", "corpus")


@functools.cache
def reader(name: str, metrics_dir: pathlib.Path = HERE / "metrics"):
    return _load_file(metrics_dir / f"{name}.py", "metric reader")


def entry_class(name: str):
    return _load_file(HERE / "entries" / f"{name}.py", "entry").Entry


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    corpus: str
    raw: np.ndarray          # the input the benchmark generated
    frame: bytes | None      # written by the frozen encoder (decode cells)
    raw_xxh32: int


def generator(seed: int, corpus_name: str, stream: int) -> np.random.Generator:
    """The seed's generator for one stream of one corpus: a corpus that
    changes leaves the others as they were."""
    entropy = [seed & (2**64 - 1), zlib.crc32(corpus_name.encode()), stream]
    return np.random.default_rng(np.random.SeedSequence(entropy))


def make_requests(cell: Cell, seed: int, size: int | None = None) -> list:
    """The cell's distinct requests from ``seed``; ``size`` replaces each
    request's size (small rehearsals and tests)."""
    write = cell.traffic["entry"] == "decode"

    def make(spec):
        n = spec["bytes"] if size is None else size
        raw = corpus(spec["corpus"]).make(
            n, generator(seed, spec["corpus"], spec.get("stream", 0)))
        raw = np.ascontiguousarray(raw, np.uint8)
        frame = (encoder.compress_frame(raw, cell.config["frame"],
                                        cell.config["level"])
                 if write else None)
        return Request(spec["corpus"], raw, frame, encoder.xxh32(raw))

    # each request on a thread of its own: numpy and the frozen encoder
    # release the interpreter lock
    specs = cell.traffic["requests"]
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        return list(pool.map(make, specs))


# ---------------------------------------------------------------------------
# the host's reading (after bench_torch/host.py)
# ---------------------------------------------------------------------------

def cpu_times() -> tuple:
    """User and kernel CPU seconds of the process so far, every
    thread's."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime, ru.ru_stime


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Window:
    """What the end-to-end readers read: every request of the window."""
    seconds: float = 0.0            # from the first call to the last answer
    setup_s: float = 0.0
    lat: list = dataclasses.field(default_factory=list)   # s, each request
    raw: list = dataclasses.field(default_factory=list)   # B, each request
    failed: int = 0


def run_window(entry, n_distinct: int, seconds: float, setup_s: float
               ) -> Window:
    """Closed loop, one client: requests in turns until ``seconds`` have
    passed; the last one started runs to its end."""
    win = Window(setup_s=setup_s)
    t0 = time.perf_counter()
    end = t0
    i = 0
    while end - t0 < seconds:
        k = i % n_distinct
        s = time.perf_counter()
        try:
            answer = entry.call(k)
            entry.sync()
        except Exception as e:      # a failed request; the run goes on
            answer = None
            win.failed += 1
            entry.note_failure(k, e)
        end = time.perf_counter()
        win.lat.append(end - s)
        win.raw.append(0 if answer is None else entry.raw_bytes(k))
        if answer is not None:
            entry.keep(k, answer)
        i += 1
    win.seconds = end - t0
    return win


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _metric(m: dict, value) -> dict:
    return {"value": value, "unit": m["unit"]}


def read_end_to_end(cell: Cell, win: Window) -> dict:
    out = {}
    for m in cell.end_to_end:
        value = reader(m["name"]).read(win)
        if value is not None:
            out[m["name"]] = _metric(m, value)
    return out


def read_per_layer(cell: Cell, trace) -> dict:
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"]).read(trace)
        if value is not None:
            out[m["name"]] = _metric(m, value)
    return out


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``lz4tpu`` is, ``lz4tpu_torch`` is not)."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*parts) -> None:
    print("[lz4bench]", *parts, file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, size: int | None = None) -> dict:
    """One run of ``cell`` on ``device``: the result's object.  ``t_start``
    is the process's start on the ``time.perf_counter`` clock."""
    import torch

    from . import tracing

    def phase(what):
        log(f"set-up: {what} {time.perf_counter() - t_start:.3f} s")

    phase("imports")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    phase("device start")
    requests = make_requests(cell, seed, size)
    phase("inputs made")
    for i, r in enumerate(requests):
        log(f"input {i}: {r.corpus} {r.raw.size} B, xxh32 "
            f"{r.raw_xxh32:08x}" + (
                "" if r.frame is None else
                f"; frame {len(r.frame)} B, xxh32 "
                f"{encoder.xxh32(np.frombuffer(r.frame, np.uint8)):08x}"))
    entry = entry_class(cell.traffic["entry"])(requests, cell.config,
                                               cell.traffic, dev)
    with entry.fallback_refused():
        for p in range(WARMUP_PASSES):
            for k in range(len(requests)):
                answer = entry.call(k)
                entry.sync()
                del answer
            phase(f"warm-up pass {p} done")
        entry.reset_counters()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t_start
        if trace:
            tr = tracing.traced_run(entry, cell, dev)
            win = None
        else:
            c0 = cpu_times()
            win = run_window(entry, len(requests), seconds, setup_s)
            user, kernel = ((b - a) / max(len(win.lat), 1) * 1e3
                            for a, b in zip(c0, cpu_times()))
            log(f"window host: cpu user {user:.1f} ms, kernel {kernel:.1f} "
                "ms a request")
            q = np.quantile(np.array(win.lat) * 1e3, [0.1, 0.5, 0.9])
            log(f"window request ms p10 {q[0]:.3f} p50 {q[1]:.3f} "
                f"p90 {q[2]:.3f}")
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        log(f"counters: {json.dumps(entry.counters())}")
        entry.after_window()
        checks = entry.judge()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct}
    if trace:
        result.update(attempted=len(tr.requests), failed=tr.failed,
                      metrics=read_per_layer(cell, tr))
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["device"] = device_info
        if tr.breakdown is not None:
            result["breakdown"] = tr.breakdown
        log(f"traced requests {len(tr.requests)}; engines "
            f"{json.dumps(tr.plans)}")
    else:
        result.update(attempted=len(win.lat), failed=win.failed,
                      metrics=read_end_to_end(cell, win))
        result["device"] = device_info
        log(f"window {win.seconds:.6f} s, {len(win.lat)} requests, "
            f"setup {setup_s:.6f} s")
    if result["failed"]:
        result["correct"] = False
    result["checks"] = checks
    return result


def main(workload: str, seed: int, seconds: float, trace: bool,
         t_start: float) -> int:
    try:
        cell = load_cell(workload)
    except (BenchError, OSError, KeyError, ValueError) as e:
        log(f"cannot load the cell: {e}")
        return 2
    try:
        import lz4tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        log(f"the program lz4tpu_torch cannot be imported: {e}: no result")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{workload} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} device(s): no result")
        return 3
    try:
        result = run(cell, seed, seconds, trace, "cuda", t_start)
    except Exception:
        log("the run failed:\n" + traceback.format_exc())
        return 1
    found = forbidden_loaded()
    if found:
        log(f"forbidden modules loaded in this process: {found}: no result")
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
