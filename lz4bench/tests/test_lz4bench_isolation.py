"""What lz4bench may load: no JAX, no JAX package, no older bench or
script, compared by whole top-level names; and a reference and inputs
that owe nothing to the program."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

from lz4bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
PKG = ROOT / "lz4bench"
#: The files that make inputs and judge answers: none imports the program.
INDEPENDENT = ["reference.py", "encoder.py", "readers.py", "corpora/*.py",
               "metrics/*.py"]


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_a_forbidden_module():
    for path in PKG.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


@pytest.mark.parametrize("pattern", INDEPENDENT)
def test_reference_and_inputs_import_nothing_of_the_program(pattern):
    for path in PKG.glob(pattern):
        assert not {"lz4tpu_torch", "torch"} & _imports(path), path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, lz4bench.reference, lz4bench.encoder, "
            "lz4bench.readers; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert "lz4tpu_torch" not in loaded and "torch" not in loaded


@pytest.mark.parametrize("name,forbidden", [
    ("lz4tpu", True), ("lz4tpu.device.fused", True), ("jax", True),
    ("jax._src.core", True), ("jaxlib", True), ("flax.linen", True),
    ("bench_torch.run", True), ("chip_smoke", True), ("kernel_times", True),
    ("lz4tpu_torch", False), ("lz4tpu_torch.pipeline", False),
    ("jaxtyping", False), ("lz4tpux", False), ("lz4bench", False)])
def test_forbidden_names_are_compared_whole(monkeypatch, name, forbidden):
    clean = {k: v for k, v in sys.modules.items()
             if k.split(".")[0] not in harness.FORBIDDEN}
    monkeypatch.setattr(sys, "modules", dict(clean, **{name: object()}))
    assert (harness.forbidden_loaded() != []) == forbidden


def test_a_cpu_run_loads_no_forbidden_module():
    code = ("import time, json; from lz4bench import harness; "
            "c = harness.load_cell('refbench-256m'); "
            "r = harness.run(c, 3, 0.1, False, 'cpu', time.perf_counter(), "
            "size=1 << 16); print(json.dumps([r['correct'], "
            "harness.forbidden_loaded()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={**os.environ, "LZ4TPU_TORCH_BUILD": "unused"})
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "-m", "lz4bench", "--workload",
                        "refbench-256m", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_with_only_the_benchmark_it_exits_nonzero(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "lz4bench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    r = subprocess.run([sys.executable, "-m", "lz4bench", "--workload",
                        "refbench-256m", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "lz4tpu_torch cannot be imported" in r.stderr
