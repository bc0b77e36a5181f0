"""chip_smoke.py refuses to report a result where it cannot run the
port on a GPU: without CUDA, and alone in a directory without the
repository; and its kernel table and phases cover what the port has."""

import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(cwd: pathlib.Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _has_ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run")
    r = _run(REPO)
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)
    assert "cuda" in r.stderr.lower()


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path)
    assert r.returncode != 0
    assert not _has_ok_line(r.stdout)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # no torch, no device at import
    return mod


def test_kernel_table_names_every_kernel_of_the_port():
    from lz4tpu_torch import _kernels

    smoke = _smoke()
    assert set(smoke.KERNELS) == set(_kernels.LAUNCHES)
    assert len(smoke.KERNELS) == 8 and "mxu2_route_ab" in smoke.KERNELS
    sources = {p.name for p in _kernels.CSRC.glob("*.cu")}
    for name, (src, replaces) in smoke.KERNELS.items():
        assert (REPO / src).is_file(), name
        assert pathlib.Path(src).name in sources, name
        path, line = replaces.rsplit(":", 1)
        text = (REPO / path).read_text().splitlines()
        assert 0 < int(line) <= len(text), name
        assert "def " in text[int(line) - 1], (name, text[int(line) - 1])
    assert smoke.KERNELS["mxu2_route_ab"] == (
        "lz4tpu_torch/csrc/mxu2_ab.cu", "exp/ab.py:34")
    # every C entry the library binds belongs to a counted kernel
    assert {e.removeprefix("lz4t_") for e in _kernels._SIGNATURES} == set(
        _kernels.LAUNCHES)


@pytest.mark.parametrize("phase", ["kernel_phase", "to_device_path",
                                   "decompress_device_path", "ab_path",
                                   "pipelined_path", "session_path",
                                   "verify_compare", "sustained_phase",
                                   "staging_phase", "error_phase",
                                   "small_fetch_phase"])
def test_main_drives_every_phase(phase):
    smoke = _smoke()
    assert callable(getattr(smoke, phase))
    main_src = (REPO / "chip_smoke.py").read_text().split("def main()")[1]
    assert f"{phase}(" in main_src
    for path in ("ab", "pipelined", "session"):
        assert f'paths["{path}"]' in main_src


def test_served_corpora_and_last_line_shape():
    smoke = _smoke()
    assert smoke.SERVED == ("z9m", "b3.5m", "frag1m", "src1m", "frag32m",
                            "frag32m-indep", "frag2m-bsum", "frag2m-legacy")
    src = (REPO / "chip_smoke.py").read_text()
    for name in smoke.SERVED:
        assert f'"{name}": (' in src    # made by corpora()
    tail = src.split("def main()")[1]
    assert tail.index('json.dumps({"kernels"') < tail.index(
        'json.dumps({"ok": True')
    assert '"platform": "gpu"' in tail


def test_session_counts_hold_only_the_sessions_launches():
    """Between setting the counts to 0 and reading them, session_path
    launches nothing itself: the reference errors of the corrupted
    frames are taken before the reset."""
    import inspect

    src = inspect.getsource(_smoke().session_path)
    before, after = src.split("_kernels.reset_launches()")
    assert "_decompress_to_device_batch(" in before
    body = after.split("counts = dict(_kernels.LAUNCHES)")[0]
    for call in ("_decompress_to_device_batch(", "decompress_to_device(",
                 "decompress_device("):
        assert call not in body, call
