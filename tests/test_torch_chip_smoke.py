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
    assert len(smoke.KERNELS) == 10 and "mxu2_route_ab" in smoke.KERNELS
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
                                   "session_path",
                                   "verify_compare", "sustained_phase",
                                   "staging_phase", "busy_phase",
                                   "error_phase", "soak_phase",
                                   "small_fetch_phase", "sharded_path",
                                   "sharded_phase", "encode_path",
                                   "encode_phase", "wheel_phase",
                                   "numpy_prep_path"])
def test_main_drives_every_phase(phase):
    smoke = _smoke()
    assert callable(getattr(smoke, phase))
    main_src = (REPO / "chip_smoke.py").read_text().split("def main()")[1]
    assert f"{phase}(" in main_src
    for path in ("ab", "session", "sharded", "encode",
                 "soak", "wheel", "numpy_prep"):
        assert f'paths["{path}"]' in main_src


def test_soak_phase_runs_fixed_seeds_before_the_last_line():
    """The soak's base seed and round count are module constants (the
    rounds are the same in every run), soak_phase runs them after the
    error phase and after the check that every fixed path's kernels
    launched, and its launches count in the kernels line."""
    import ast
    import inspect

    smoke = _smoke()
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    consts = {t.id: node.value for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name)}
    for name in ("SOAK_SEED", "SOAK_ROUNDS"):
        assert isinstance(consts[name], ast.Constant), name
        assert isinstance(getattr(smoke, name), int), name
    assert smoke.SOAK_ROUNDS > 0
    src = inspect.getsource(smoke.soak_phase)
    assert "soak.soak(SOAK_SEED, \"cuda\", rounds=SOAK_ROUNDS)" in src
    assert "cover.require(\"cuda\")" in src
    main_src = (REPO / "chip_smoke.py").read_text().split("def main()")[1]
    at = main_src.index('paths["soak"] = soak_phase(')
    assert main_src.index("was never launched") < at
    assert main_src.index("error_phase(") < at
    assert at < main_src.index("launches = {") < main_src.index(
        'json.dumps({"kernels"') < main_src.index('json.dumps({"ok": True')


def test_sharded_tier_names_each_tier():
    """The tier the sharded path asserts for a corpus is the one
    decompress_sharded takes: the resolver, span units or chain groups
    (small stand-ins, on CPU meshes)."""
    import numpy as np

    import lz4tpu_torch as lt
    import lz4tpu_torch.pipeline as tpl
    from lz4tpu_torch import dist

    smoke = _smoke()
    text = smoke.frag_text(np, 400_000, 8192, 3, 8, 11)
    cases = {"zeros": (lt.compress(bytes(600_000)), "resolver", "resolver"),
             "text": (lt.compress(text), "resolver", "spans"),
             "indep": (lt.compress(text, block_max_code=4,
                                   block_independence=True),
                       "chains", "chains")}
    for name, (data, one, four) in cases.items():
        for n, want in ((1, one), (4, four)):
            tier, units = smoke.sharded_tier(np, lt, tpl, dist, data,
                                             dist.make_mesh(n, "cpu"))
            assert tier == want, (name, n)
            assert (units is None) == (tier == "resolver")
    corp = {k: (b"", b"") for k in smoke.SERVED}
    corp["z9m"] = (b"", bytes(1 << 20))
    cases = smoke.sharded_corpora(lt, corp)
    assert list(cases) == [*smoke.SERVED, "z9m-indep"]
    assert lt.decompress(cases["z9m-indep"][0]) == bytes(1 << 20)
    assert set(smoke.SHARDED_FOUR) == set(cases)
    assert set(smoke.SHARDED_ONE) <= set(cases)


def test_host_decode_refused_catches_the_fallback():
    """Inside host_decode_refused a frame that decompress_sharded hands
    to the host engine fails the smoke when the block ends; a sound
    frame decodes; decompress_host itself is left as it was."""
    import lz4tpu_torch as lt
    from lz4tpu_torch import api, dist

    smoke = _smoke()
    data = bytearray(lt.compress(bytes(range(256)) * 512))
    mesh = dist.make_mesh(2, "cpu")
    real = api.decompress_host
    with smoke.host_decode_refused():
        assert dist.decompress_sharded(bytes(data), mesh) == (
            bytes(range(256)) * 512)
    data[-1] ^= 1                       # the content checksum
    with pytest.raises(smoke.SmokeFailure, match="fell back to the host"):
        with smoke.host_decode_refused():
            with pytest.raises(lt.ChecksumError):
                dist.decompress_sharded(bytes(data), mesh)
    assert api.decompress_host is real
    with pytest.raises(lt.Lz4Error):
        dist.decompress_sharded(bytes(data), mesh)


def test_native_prep_off_refuses_and_restores():
    """Inside native_prep_off the port plans with its numpy prep (the
    engine reads as absent) and every native prep, pack and resolve
    function fails the smoke, also when a caller swallows the failure;
    on exit all of them are the engine's again."""
    import numpy as np

    import lz4tpu_torch as lt
    from lz4tpu_torch import native

    smoke = _smoke()
    saved = {n: getattr(native, n)
             for n in ("available",) + smoke.NATIVE_PREP}
    assert set(smoke.NUMPY_PREP) <= set(smoke.SERVED)
    blob = smoke.frag_text(np, 200_000, 8192, 3, 8, 11)
    data = lt.compress(blob)
    with smoke.native_prep_off():
        assert not native.available()
        assert lt.decompress_to_device(data, device="cpu").numpy(
            ).tobytes() == blob
    with pytest.raises(smoke.SmokeFailure, match="ran with the engine off"):
        with smoke.native_prep_off():
            native.pack_dense2_chain()
    with pytest.raises(smoke.SmokeFailure, match="reached with the engine"):
        with smoke.native_prep_off():
            try:
                native.resolve_window()
            except smoke.SmokeFailure:
                pass
    assert {n: getattr(native, n) for n in saved} == saved
    assert native.available()


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


def test_segment_shapes_are_shared_by_kernel_phase_and_device_path():
    """The four H6 shapes are made in one place: small stand-ins for the
    corpora go in, names and independent 64 KiB blocks come out."""
    import inspect

    import numpy as np

    import lz4tpu_torch as lt

    smoke = _smoke()
    text = smoke.frag_text(np, 200_000, 512, 3, 8, 1)
    corp = {k: (lt.compress(text), text) for k in ("frag1m", "src1m",
                                                   "frag32m")}
    shapes = smoke.segment_shapes(np, lt, corp)
    assert [s[0] for s in shapes] == [
        "frag1m", "indep2m", "frag32m in independent 64 KiB blocks", "src1m"]
    for _name, data, blob in shapes:
        assert lt.decompress(data) == blob
    assert len(shapes[1][2]) == 2 << 20
    blocks = lt.frame.parse_frames(np.frombuffer(shapes[2][1], np.uint8),
                                   lt.FOR_ALL).frames[0].blocks
    assert len(blocks) == -(-len(text) // 65536)
    for fn in ("kernel_phase", "decompress_device_path"):
        assert "segment_shapes(np, lt, corp)" in inspect.getsource(
            getattr(smoke, fn))


def test_kernel_times_takes_its_inputs_from_chip_smoke():
    """The in-turns timing script lies beside chip_smoke.py, imports
    neither JAX nor the JAX package, and declares no corpus of its own."""
    src = (REPO / "kernel_times.py").read_text()
    assert "import chip_smoke as cs" in src
    assert "cs.corpora(np, lt)" in src and "cs.segment_shapes(" in src
    for word in ("import jax", "lz4tpu.", "import lz4tpu\n", "frag_text(",
                 "default_rng"):
        assert word not in src, word
    r = subprocess.run([sys.executable, "kernel_times.py", "--help"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "--turns" in r.stdout


def test_candidate_devices_sees_both_passes():
    """candidate_devices records the device of every tensor the two
    device passes return, and puts the passes back afterwards."""
    import numpy as np

    import lz4tpu_torch as lt
    from lz4tpu_torch import dist
    from lz4tpu_torch.device import encode as enc

    smoke = _smoke()
    real = enc._candidates_compact_device
    text = smoke.frag_text(np, 90_000, 512, 3, 8, 2)
    with smoke.candidate_devices(enc) as seen:
        lt.compress(text, backend="device", device="cpu")
        lt.compress(text, backend="device-emit", device="cpu")
        dist.compress_sharded(text, dist.make_mesh(2, "cpu"))
    assert len(seen) == 1 + 2 + 2
    assert {d.type for d in seen} == {"cpu"}
    assert enc._candidates_compact_device is real


def test_wheel_phase_runs_every_decode_kernel_from_an_installed_tree():
    """The wheel phase builds the wheel, installs it with pip --target
    and drives the main path in a process that sees only the installed
    tree (jax and lz4tpu blocked, no LZ4TPU_* variable); its calls
    between them must launch every decode kernel and the encoder, and
    its launches join the paths' before the check that every kernel
    was launched."""
    import inspect

    from lz4tpu_torch import _kernels

    smoke = _smoke()
    wanted = {k for _name, _how, ks in smoke.WHEEL_CALLS for k in ks}
    assert wanted == set(_kernels.LAUNCHES) - {"mxu2_route_ab"}
    assert [how for _n, how, _k in smoke.WHEEL_CALLS].count("encode") == 1
    assert {how for _n, how, _k in smoke.WHEEL_CALLS} == {
        "to_device", "pallas", "encode"}
    src = inspect.getsource(smoke.wheel_phase)
    for word in ("build_meta.build_wheel", '"pip", "install"', "--target",
                 'startswith("LZ4TPU_")', 'env["PYTHONPATH"] = str(site)',
                 '"lz4tpu-bench-torch"', 'res["host_fallbacks"] == 0',
                 '(HERE / "build" / "lz4tpu_torch").exists()'):
        assert word in src, word
    for word in ('sys.modules["jax"] = None', 'sys.modules["lz4tpu"] = None',
                 "_kernels.build()", 'verify="device"', 'engine="pallas"',
                 'backend="device"', "lt.decompress_host("):
        assert word in smoke.WHEEL_MAIN, word
    main_src = (REPO / "chip_smoke.py").read_text().split("def main()")[1]
    assert main_src.index('paths["wheel"] = wheel_phase(') < main_src.index(
        "was never launched")
