"""bench_torch, the port's bench, on the CPU: its corpora are fixed by
the seed and by nothing in the checkout, each corpus plans as its cell
says, a changed compressed input is refused, the latency percentiles
keep ten samples beyond them, and a rehearsal of the cell loops on
``device="cpu"`` fails on a wrong output byte and reports every device
metric as "not measured".  ``python -m bench_torch`` itself refuses to
run without CUDA."""

import ast
import dataclasses
import json
import math
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lz4tpu_torch
from bench_torch import corpora, host, run, spread
from lz4tpu_torch import serve

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "bench_torch"
SMALL = 64 << 10
SEED = corpora.DEFAULT_SEED

_DIGEST = (
    "import hashlib\n"
    "from bench_torch import corpora\n"
    "for cell in corpora.CELLS:\n"
    "    reqs = corpora.cell_requests(cell, 7, 1 << 16)\n"
    "    h = hashlib.sha256(b''.join(r.orig for r in reqs)).hexdigest()\n"
    "    print(cell.name, corpora.digest(reqs), h)\n")


@pytest.fixture(scope="module")
def words_full():
    """The words cells' requests at full size (32 MiB)."""
    return {name: corpora.cell_requests(corpora.CELL[name], SEED)
            for name in ("words32m-linked", "words32m-cli")}


@pytest.fixture(scope="module")
def rehearsal():
    """words32m-linked's cell loop on the CPU at 64 KiB."""
    with run.fallback_refused():
        return run.bench_cell(corpora.CELL["words32m-linked"], SEED, "cpu",
                              size=SMALL)


def test_corpora_are_fixed_by_the_seed():
    for kind in corpora.ENGINE:
        a = corpora.corpus(kind, SMALL, SEED)
        assert len(a) == SMALL
        assert a == corpora.corpus(kind, SMALL, SEED), kind
        if kind != "zeros":
            assert a != corpora.corpus(kind, SMALL, SEED + 1), kind
    cell = corpora.CELL["session-mix"]
    one = corpora.cell_requests(cell, SEED, SMALL)
    assert len(one) == corpora.SESSION_REQUESTS
    assert [r.orig for r in one] == [
        r.orig for r in corpora.cell_requests(cell, SEED, SMALL)]
    sizes = [len(r.orig) for r in one]
    assert SMALL // 32 <= min(sizes) and max(sizes) <= SMALL


def test_corpora_do_not_move_with_the_checkout_text(tmp_path):
    copy = tmp_path / "checkout"
    skip = shutil.ignore_patterns("__pycache__", "build", "_build")
    for name in ("bench_torch", "lz4tpu_torch"):
        shutil.copytree(REPO / name, copy / name, ignore=skip)
    for rel in ("lz4tpu_torch/pipeline.py", "bench_torch/run.py",
                "lz4tpu_torch/device/mxu2.py"):
        with open(copy / rel, "a") as f:
            f.write("\n# a changed line of program text\n"
                    "_UNUSED = 'changes the text, not the program'\n")

    def digests(where):
        r = subprocess.run([sys.executable, "-c", _DIGEST], cwd=where,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        return r.stdout

    here = digests(REPO)
    assert here.count("\n") == len(corpora.CELLS)
    assert digests(copy) == here


@pytest.mark.parametrize("name", ["words32m-linked", "words32m-cli"])
def test_words_plan_and_record_at_full_size(words_full, name):
    cell = corpora.CELL[name]
    reqs = words_full[name]
    mixes = [corpora.engine_mix(r.comp) for r in reqs]
    assert mixes == [{"dense": 1 if name.endswith("linked") else 8}]
    corpora.check_engines(cell, reqs, mixes)
    assert corpora.check_record(cell, SEED, reqs) == tuple(
        corpora.RECORDED[SEED][name])


@pytest.mark.parametrize("name, size, want", [
    ("frag32m-linked", 4 << 20, [{"fused": 1}]),
    ("refbench-256m", 8 << 20, [{"sparse": 2}, {"sparse": 2}]),
])
def test_engine_mix_of_each_corpus(name, size, want):
    cell = corpora.CELL[name]
    reqs = corpora.cell_requests(cell, SEED, size)
    mixes = [corpora.engine_mix(r.comp) for r in reqs]
    assert mixes == want
    corpora.check_engines(cell, reqs, mixes)


def test_session_requests_plan_as_their_kinds():
    cell = corpora.CELL["session-mix"]
    reqs = corpora.cell_requests(cell, SEED, 2 << 20)
    mixes = [corpora.engine_mix(r.comp) for r in reqs]
    corpora.check_engines(cell, reqs, mixes)
    assert {r.kind for r in reqs} <= set(corpora.SESSION_MIX)
    bad = dataclasses.replace(
        reqs[0], kind="zeros" if reqs[0].kind != "zeros" else "words")
    with pytest.raises(corpora.InputChanged, match="plans as"):
        corpora.check_engines(cell, [bad], mixes[:1])


def test_recorded_input_refuses_a_changed_one(words_full):
    cell = corpora.CELL["words32m-linked"]
    (req,) = words_full["words32m-linked"]
    comp = bytearray(req.comp)
    comp[len(comp) // 2] ^= 1
    changed = dataclasses.replace(req, comp=bytes(comp))
    with pytest.raises(corpora.InputChanged, match="encoder's output"):
        corpora.check_record(cell, SEED, [changed])
    with pytest.raises(corpora.InputChanged, match="no recorded input"):
        corpora.check_record(cell, 12345, [req])
    for seed, cells in corpora.RECORDED.items():
        assert set(cells) == set(corpora.CELL), seed


def test_percentile_keeps_ten_samples_beyond():
    xs = list(range(1, 41))                     # 40 samples
    assert run.percentile(xs, 75) == 30
    assert run.percentile(xs, 50) == 20
    assert run.percentile(list(reversed(xs)), 75) == 30
    with pytest.raises(ValueError, match="needs 10"):
        run.percentile(xs[:39], 75)
    assert run.percentile(xs[:20], 50) == 10
    with pytest.raises(ValueError, match="needs 10"):
        run.percentile(xs[:19], 50)
    assert run.TIMED * (1 - 0.75) >= 10
    assert (run.SESSION_ROUNDS * corpora.SESSION_REQUESTS) * 0.25 >= 10


def test_json_line_names_every_metric_with_its_unit(rehearsal):
    cell = json.loads(json.dumps(rehearsal))
    assert cell["config"] == "lz4f-linked"
    assert set(cell["metrics"]) == set(run.METRICS)
    for name, unit in run.METRICS.items():
        m = cell["metrics"][name]
        assert m["unit"] == unit and "value" in m, name
    assert cell["metrics"]["request_ms_p75"]["samples"] == run.TIMED
    assert cell["metrics"]["ops_attempted"]["value"] == run.TIMED
    assert cell["metrics"]["ops_failed"]["value"] == 0
    assert set(cell["layers"]) == set(run.LAYERS)
    for name, unit in run.LAYERS.items():
        m = cell["layers"][name]
        assert m["unit"] == unit.format(unit="request") and "value" in m
    assert set(cell["host"]) == set(run.HOST)
    for name, unit in run.HOST.items():
        m = cell["host"][name]
        assert m["unit"] == unit.format(unit="request") and "value" in m
    assert cell["host"]["host_cpu_ms"]["value"] > 0
    assert cell["source"] == corpora.CELL["words32m-linked"].source
    assert set(cell["kernels"]) == set(run.KERNELS)
    for k in cell["kernels"].values():
        assert k["port"] in {"H1", "H2", "H3", "H4", "H5"}
        assert {"value", "unit"} <= set(k["ms"]) | set(k["launches"])
    for name in ("prepare_s", "warmup_s"):
        assert cell["setup"][name]["unit"] == "s"
    assert cell["input"]["engines"] == corpora.engine_mix(
        corpora.cell_requests(corpora.CELL["words32m-linked"], SEED,
                              SMALL)[0].comp)


def test_rehearsal_reports_device_metrics_as_not_measured(rehearsal):
    layers = rehearsal["layers"]
    for name in ("engines_ms", "device_busy_share", "peak_device_bytes"):
        assert layers[name]["value"] == run.NOT_MEASURED, name
    for k in rehearsal["kernels"].values():
        assert k["ms"]["value"] == run.NOT_MEASURED
        assert k["launches"]["value"] == run.NOT_MEASURED
    assert rehearsal["breakdown"] == {"top_ops": run.NOT_MEASURED,
                                      "idle_gaps": run.NOT_MEASURED}
    for name in ("parse_ms", "scan_ms", "plan_ms", "verify_ms",
                 "traced_ms"):
        assert layers[name]["value"] > 0, name
    assert rehearsal["metrics"]["decode_gbps"]["value"] > 0


def _flip(t):
    t = t.clone()
    t[t.shape[0] // 3] ^= 1
    return t


def test_rehearsal_fails_on_a_flipped_output_byte(monkeypatch):
    real = lz4tpu_torch.decompress_to_device
    monkeypatch.setattr(lz4tpu_torch, "decompress_to_device",
                        lambda *a, **k: _flip(real(*a, **k)))
    with run.fallback_refused(), pytest.raises(
            run.BenchFailure, match="differs from the original first at"):
        run.bench_cell(corpora.CELL["words32m-linked"], SEED, "cpu",
                       size=SMALL)


def test_session_rehearsal_fails_on_a_flipped_output_byte(monkeypatch):
    real = serve.DecodeTicket.result_on_device
    monkeypatch.setattr(serve.DecodeTicket, "result_on_device",
                        lambda self, *a, **k: _flip(real(self, *a, **k)))
    with run.fallback_refused(), pytest.raises(
            run.BenchFailure, match="24 of 24 requests failed"):
        run.bench_cell(corpora.CELL["session-mix"], SEED, "cpu",
                       size=SMALL // 4)


def test_a_fallback_to_the_host_engine_fails_the_bench():
    orig = corpora.corpus("frag", 20000, SEED)
    comp = bytearray(lz4tpu_torch.compress(orig))
    comp[-1] ^= 1                       # the content checksum
    with pytest.raises(lz4tpu_torch.ChecksumError):
        lz4tpu_torch.decompress_to_device(bytes(comp), device="cpu",
                                          verify="device")
    with run.fallback_refused(), pytest.raises(run.BenchFailure,
                                               match="fell back"):
        lz4tpu_torch.decompress_to_device(bytes(comp), device="cpu",
                                          verify="device")


def test_device_profile_reads_busy_share_kernels_ops_and_gaps():
    # two requests (0-100 us, 110-200 us) and the bench's comparison
    # between them (102-108 us, outside both); device work at 10-30 (two
    # overlapping kernels), 50-60 and 150-190
    spans = [(0, 100, "request"), (110, 200, "request"), (0, 40, "plan"),
             (40, 100, "engines"), (110, 200, "verify")]
    dev_ev = [(10, 30, "mxu2_jump_kernel(int4*, int*, int, unsigned long)"),
              (20, 25, "mxu2_jump_kernel(int4*, int*, int, unsigned long)"),
              (50, 60, "Memcpy HtoD (Pinned -> Device)"),
              (102, 108, "void at::native::reduce_kernel<512, 1>"),
              (150, 190, "(anonymous namespace)::xxh32_stream_kernel("
                         "unsigned char const*)")]
    got = run.device_profile(dev_ev, spans, "request", units=2)
    assert got["busy"] == pytest.approx((20 + 10 + 40) / 190)
    assert got["kernel_ms"]["mxu2_route"] == pytest.approx(25 / 1e3 / 2)
    assert got["kernel_ms"]["xxh32_stream"] == pytest.approx(40 / 1e3 / 2)
    assert got["kernel_ms"]["fused_route"] == 0
    assert [row[:2] for row in got["top_ops"]] == [
        ["verify", "xxh32_stream_kernel(unsigned char const*)"],
        ["plan", "mxu2_jump_kernel(int4*, int*, int, unsigned long)"],
        ["engines", "Memcpy HtoD (Pinned -> Device)"]]
    # an operation that starts a little before its span opens is placed
    # by where it spends its time
    late = run.device_profile([(109, 150, "xxh32_stream_kernel(x)")],
                              spans + [(100, 109.5, "engines")], "request",
                              units=1)
    assert late["top_ops"][0][0] == "verify"
    # each gap under the span that overlaps it most; a tie goes to the
    # first span
    assert got["idle_gaps"] == [[0.04, "verify"], [0.04, "engines"],
                                [0.02, "plan"], [0.01, "verify"],
                                [0.01, "plan"]]
    assert run.device_profile(dev_ev[3:4], spans, "request", 2) == {
        "busy": run.NOT_MEASURED, "kernel_ms": {},
        "top_ops": run.NOT_MEASURED, "idle_gaps": run.NOT_MEASURED}


def test_spread_sets_the_bound_from_the_runs():
    def runs(values):
        return [{"cells": {"c": {
            "metrics": {k: {"value": v, "unit": u}
                        for k, u in run.METRICS.items()},
            "layers": {k: {"value": v, "unit": u}
                       for k, u in run.LAYERS.items()},
            "host": {k: {"value": v, "unit": u}
                     for k, u in run.HOST.items()}}}}
            for v in values]

    tight = spread.spread(runs([100.0, 100.5, 101.0, 99.5, 100.2]))
    assert tight["c"]["decode_gbps"]["bound"] == spread.FLOOR
    wide = spread.spread(runs([80.0, 90.0, 100.0, 110.0, 120.0]))["c"]
    assert wide["request_ms_p75"]["bound"] == pytest.approx(2 * 20 / 100)
    assert wide["decode_gbps"]["median"] == 100.0
    assert "bound" not in wide["ops_failed"]
    assert "bound" not in wide["parse_ms"]
    assert "bound" not in wide["host_cpu_ms"]
    # p50 across runs against the host readings and stages
    rs = runs([80.0, 90.0, 100.0, 110.0, 120.0])
    for i, r in enumerate(rs):
        r["cells"]["c"]["host"]["host_steal_share"]["value"] = [
            0.3, 0.1, 0.2, 0.0, 0.4][i]
        r["cells"]["c"]["host"]["host_others_cpus"]["value"] = 1.0
        r["cells"]["c"]["layers"]["scan_ms"]["value"] = "not measured"
    corr = spread.correlate(rs)["c"]
    assert corr["plan_ms"] == pytest.approx(1.0)
    assert corr["host_steal_share"] == pytest.approx(0.1)
    assert corr["host_others_cpus"] is None
    assert corr["scan_ms"] is None


def test_bench_imports_no_jax_lz4tpu_chip_smoke_or_kernel_times():
    allowed = {"__future__", "argparse", "collections", "contextlib",
               "dataclasses", "glob", "hashlib", "json", "math", "os",
               "resource", "statistics", "subprocess", "sys", "time",
               "numpy", "torch", "lz4tpu_torch"}
    files = sorted(BENCH.glob("*.py"))
    assert {f.name for f in files} >= {"__main__.py", "corpora.py",
                                       "host.py", "run.py", "spread.py"}
    for path in files:
        text = path.read_text()
        if path.name == "host.py":      # the kernel's files, no other
            paths = [node.value for node in ast.walk(ast.parse(text))
                     if isinstance(node, ast.Constant)
                     and isinstance(node.value, str)
                     and node.value.startswith("/")]
            assert paths and all(p.startswith(("/proc/", "/sys/"))
                                 for p in paths), paths
        elif path.name != "spread.py":  # it reads the runs' output
            assert "open(" not in text and "read_" not in text, path
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, (path.name, m)


def test_bench_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run")
    r = subprocess.run([sys.executable, "-m", "bench_torch"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "cuda" in r.stderr.lower()
    assert "decode_gbps" not in r.stdout
    assert not any(line.lstrip().startswith("{")
                   for line in r.stdout.splitlines())


def test_session_rate_is_all_bytes_over_all_time(monkeypatch):
    # three rounds of 1, 1 and 4 s: a stalled round moves the rate (the
    # median of the rounds' rates would not)
    times = iter([9.0, 1.0, 1.0, 4.0])
    cell = corpora.CELL["session-mix"]
    reqs = [corpora.Request("zeros", b"", bytes(1000), None)] * 2
    refs = [torch.zeros(1000, dtype=torch.uint8)] * 2

    def round_(session, requests, dev, lat, spans=False):
        lat += [0.5] * len(requests)
        return next(times), list(refs)

    monkeypatch.setattr(run, "_session_round", round_)
    got = run.run_session(cell, reqs, refs, torch.device("cpu"),
                          run._Deadline(cell.name), session=None)
    assert got["gbps"] == pytest.approx(3 * 2000 / 6.0 / 1e9)
    assert got["rounds_gbps"] == pytest.approx([2e-6, 2e-6, 5e-7])
    assert got["attempted"] == 3 * 2
    assert len(got["cpu"]) == len(got["switches"]) == 3


def test_host_readings():
    m = host.machine()
    assert m["affinity_cpus"] >= 1 and m["online_cpus"] >= 1
    w = host.Window()
    w.start()
    t = time.perf_counter()
    while time.perf_counter() - t < 0.05:
        pass
    w.stop()
    if w.steal_share is not None:      # Linux: /proc/stat
        assert 0.0 <= w.steal_share <= 1.0
        assert math.isfinite(w.others_cpus)
    user, kernel, switches = host.process()
    assert user + kernel > 0 and switches >= 0


def test_a_made_up_proc_stat_is_not_measured(monkeypatch):
    # a sandbox whose /proc/stat counts less work than this process did
    still = dict.fromkeys(host._FIELDS, 100)
    monkeypatch.setattr(host, "_stat", lambda: dict(still))
    w = host.Window()
    w.start()
    t = time.process_time()
    while time.process_time() - t < 0.05:
        pass
    still["idle"] += 50
    w.stop()
    assert w.steal_share is None and w.others_cpus is None


def test_every_cell_names_its_source():
    for cell in corpora.CELLS:
        assert cell.source.startswith("config: lz4"), cell.name
        assert len(cell.source) <= 200, cell.name
    assert "unsourced" in corpora.CELL["session-mix"].source


def test_words_text_is_zipf_words():
    text = corpora.words_text(SMALL, SEED)
    words = text.replace(b",", b" ").replace(b".", b" ").split()
    assert all(2 <= len(w) <= 10 and w.isalpha() and w.islower()
               for w in words)
    counts = np.sort(np.unique(words, return_counts=True)[1])[::-1]
    assert counts[0] > 20 * np.median(counts)
