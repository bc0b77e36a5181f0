"""The check's control and its planted faults come out not correct: the
rest of a run is driven as the benchmark drives it (on the CPU, past the
look for a card), with the timed path broken underneath."""

import json
import pathlib

import pytest

from lz4bench import control, harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("mode", control.MODES)
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_are_not_correct(workload, mode):
    cell = harness.load_cell(workload)
    out = control.run_planted(cell, 2**31 + 11, 0.5, mode, "cpu",
                              size=64 << 10)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_program_is_restored_after_a_planted_run():
    import lz4tpu_torch

    real = (lz4tpu_torch.decompress_to_device, lz4tpu_torch.compress)
    with control.planted("decode", "alter"):
        assert lz4tpu_torch.decompress_to_device is not real[0]
    with control.planted("encode", "half"):
        assert lz4tpu_torch.compress is not real[1]
    assert (lz4tpu_torch.decompress_to_device, lz4tpu_torch.compress) == real


def test_the_control_fails_the_checksum_guarantee_alone():
    """A decode control decodes every byte right and is caught only by
    the checksum it does not check."""
    out = control.run_planted(harness.load_cell("refbench-256m"), 5, 0.5,
                              "control", "cpu", size=64 << 10)
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert checks == {"wrong_bytes": 0, "failed": 0, "verify_missed": 2}


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_card):
    import time

    cell = harness.load_cell("refbench-256m")
    for trace in (False, True):
        out = harness.run(cell, 3, 0.5, trace, "cuda", time.perf_counter(),
                          size=1 << 20)
        assert out["correct"], out["checks"]
        assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and "kernel_roofline.decode" in \
        out["metrics"]


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
