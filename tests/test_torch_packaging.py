"""lz4tpu_torch in the wheel: the port's modules and kernel sources ship
as source, its six console tools are installed, and an unpacked or
installed tree runs on its own, with ``jax`` and ``lz4tpu`` blocked.

The wheel and the sdist are built with setuptools' PEP 517 backend from
a copy of the tree in a temporary directory, never in the checkout:
``tests/test_packaging.py`` builds in the checkout's ``build/`` and then
removes it, and may run at the same time in another worker.  The copy
carries planted ``.so`` files (a kernel library in ``_build/`` and a
native engine), so "no binary in the wheel" is a real check.

The kernel cache's default lies in the package's own ``_build/``, in a
checkout and in an unpacked tree alike, never under a checkout's
``build/``; ``LZ4TPU_TORCH_BUILD`` overrides it.

The JAX package is imported only inside the test that compares the
console tools with it, so the card test runs where ``jax`` is absent.
"""

import configparser
import io
import os
import pathlib
import shutil
import subprocess
import sys
import tarfile
import zipfile

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "lz4tpu_torch"

SCRIPTS = {
    "unlz4tpu-torch": "lz4tpu_torch.cli:main_unlz4",
    "unlz4tpu-simple-torch": "lz4tpu_torch.cli:main_unlz4_simple",
    "lz4tpu-hdrinfo-torch": "lz4tpu_torch.cli:main_lz4hdrinfo",
    "lz4tpu-xxhash32-torch": "lz4tpu_torch.cli:main_xxhash32",
    "lz4tpu-compress-torch": "lz4tpu_torch.cli:main_compress",
    "lz4tpu-bench-torch": "lz4tpu_torch.cli:main_bench",
}

# the planted binaries: the wheel must leave both out
PLANTED = ("lz4tpu_torch/_build/liblz4tpu_kernels.so",
           "lz4tpu_torch/native/_lz4core.so")

BLOCK = ('import sys\n'
         'sys.modules["jax"] = None\n'
         'sys.modules["lz4tpu"] = None\n')


def _env(site: pathlib.Path) -> dict:
    """The environment of a process that sees only ``site``: no repo on
    the path, no cache override."""
    env = dict(os.environ, PYTHONPATH=str(site))
    env.pop("LZ4TPU_TORCH_BUILD", None)
    return env


def _source_files(root: pathlib.Path) -> set[str]:
    """The port's ``.py`` modules and kernel and engine sources under
    ``root``, as paths relative to it."""
    pkg = root / "lz4tpu_torch"
    files = [p for p in pkg.rglob("*.py") if "__pycache__" not in p.parts]
    files += list((pkg / "csrc").glob("*.cu"))
    files += list((pkg / "csrc").glob("*.cuh"))
    files.append(pkg / "native" / "lz4core.cpp")
    return {str(p.relative_to(root)) for p in files}


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    """(wheel, sdist, copied tree): both built in a copy of the tree."""
    tmp = tmp_path_factory.mktemp("torch_wheel")
    src = tmp / "src"
    skip = shutil.ignore_patterns("__pycache__", "*.so", "_build", "build")
    for name in ("lz4tpu", "lz4tpu_torch"):
        shutil.copytree(REPO / name, src / name, ignore=skip)
    for name in ("pyproject.toml", "README.md", "LICENSE"):
        shutil.copy(REPO / name, src / name)
    for rel in PLANTED:
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_bytes(b"\x7fELF not a library")
    out = tmp / "dist"
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from setuptools import build_meta\n"
         "out = sys.argv[1]\n"       # the backend rewrites sys.argv
         "build_meta.build_sdist(out)\n"
         "build_meta.build_wheel(out)\n", str(out)],
        cwd=src, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    wheels, sdists = list(out.glob("*.whl")), list(out.glob("*.tar.gz"))
    assert len(wheels) == 1 and len(sdists) == 1, r.stdout[-2000:]
    return wheels[0], sdists[0], src


@pytest.fixture(scope="module")
def unpacked(dist, tmp_path_factory):
    site = tmp_path_factory.mktemp("unpacked") / "site"
    with zipfile.ZipFile(dist[0]) as z:
        z.extractall(site)
    return site


@pytest.fixture(scope="module")
def installed(dist, tmp_path_factory):
    """``pip install --target`` of the wheel, offline; its scripts in
    ``bin/``."""
    site = tmp_path_factory.mktemp("installed") / "site"
    r = subprocess.run(
        [sys.executable, "-m", "pip", "install", "--no-deps", "--no-index",
         "--no-compile", "--disable-pip-version-check", "--target",
         str(site), str(dist[0])],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return site


def _build_dir_of(where: pathlib.Path, env: dict) -> pathlib.Path:
    r = subprocess.run(
        [sys.executable, "-c",
         BLOCK + "from lz4tpu_torch import _kernels\n"
         "print(_kernels.BUILD_DIR)\n"],
        cwd=where, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return pathlib.Path(r.stdout.strip())


def test_kernel_cache_default_is_the_package_build_dir(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("LZ4TPU_TORCH_BUILD", None)
    got = _build_dir_of(tmp_path, env)
    assert got == PKG / "_build"
    assert not got.resolve().is_relative_to((REPO / "build").resolve())
    assert "lz4tpu_torch/_build/" in (REPO / ".gitignore").read_text()
    env["LZ4TPU_TORCH_BUILD"] = str(tmp_path / "elsewhere")
    assert _build_dir_of(tmp_path, env) == tmp_path / "elsewhere"


def test_wheel_holds_every_module_and_source(dist):
    wheel, _sdist, _src = dist
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
    want = _source_files(REPO)
    assert {"lz4tpu_torch/device/fused.py", "lz4tpu_torch/exp/soak.py",
            "lz4tpu_torch/native/__init__.py", "lz4tpu_torch/csrc/fused.cu",
            "lz4tpu_torch/csrc/common.cuh",
            "lz4tpu_torch/native/lz4core.cpp"} <= want
    assert len([n for n in want if n.endswith(".cu")]) == 6
    assert want <= names, sorted(want - names)


def test_wheel_holds_no_binary(dist):
    wheel, _sdist, src = dist
    assert all((src / rel).is_file() for rel in PLANTED)
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
    assert not [n for n in names if n.endswith(".so")]
    assert not [n for n in names if "/_build/" in n or "/build/" in n]


def test_entry_points_map_the_six_torch_scripts(dist):
    with zipfile.ZipFile(dist[0]) as z:
        entry = next(n for n in z.namelist()
                     if n.endswith(".dist-info/entry_points.txt"))
        text = z.read(entry).decode()
    cfg = configparser.ConfigParser()
    cfg.read_string(text)
    scripts = dict(cfg["console_scripts"])
    for name, target in SCRIPTS.items():
        assert scripts[name] == target, name
    # the JAX package's six stay its own
    assert scripts["unlz4tpu"] == "lz4tpu.cli:main_unlz4"
    assert sum(v.startswith("lz4tpu_torch.") for v in scripts.values()) == 6


def test_sdist_holds_the_same_sources(dist):
    wheel, sdist, _src = dist
    with tarfile.open(sdist) as t:
        names = {n.split("/", 1)[1] for n in t.getnames() if "/" in n}
    assert _source_files(REPO) <= names
    assert not [n for n in names if n.endswith(".so") or "_build/" in n]
    assert "pyproject.toml" in names


UNPACKED = BLOCK + r'''
import pathlib
import numpy as np
import lz4tpu_torch
from lz4tpu_torch import _kernels, native
site = pathlib.Path(sys.argv[1]).resolve()
assert pathlib.Path(lz4tpu_torch.__file__).resolve().is_relative_to(site)
assert _kernels.BUILD_DIR.resolve() == site / "lz4tpu_torch" / "_build"
assert native.available()
assert pathlib.Path(native._SO).resolve().parent == \
    site / "lz4tpu_torch" / "native"
assert pathlib.Path(native._SO).is_file()
rng = np.random.default_rng(1111)
frags = [rng.integers(32, 127, int(rng.integers(3, 12)),
                      dtype=np.uint8).tobytes() for _ in range(2048)]
text = b"".join(frags[i] for i in rng.integers(0, 2048, 40000))[:200000]
payload = text + bytes(70000) + rng.integers(0, 256, 30000,
                                             dtype=np.uint8).tobytes()
for kw in ({}, {"block_checksum": True, "block_max_code": 4},
           {"content_size": True, "block_independence": True}):
    frame = lz4tpu_torch.compress(payload, **kw)
    assert lz4tpu_torch.decompress(frame, backend="host") == payload, kw
    on_dev = lz4tpu_torch.decompress_to_device(frame, device="cpu")
    assert on_dev.numpy().tobytes() == payload, kw
    assert lz4tpu_torch.decompress_device(frame, device="cpu") == payload
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert "jax" not in loaded and "lz4tpu" not in loaded
print("unpacked OK")
'''


def test_unpacked_tree_compresses_and_decodes_alone(unpacked, tmp_path):
    r = subprocess.run([sys.executable, "-c", UNPACKED, str(unpacked)],
                       cwd=tmp_path, env=_env(unpacked), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "unpacked OK" in r.stdout
    assert not (REPO / "build" / "lz4tpu_torch").exists()


def _jax_cli(argv, stdin: bytes = b""):
    """(rc, stdout, stderr) of ``lz4tpu.cli.main(argv)`` in process."""
    from lz4tpu import cli as jcli

    in_b, out_b, err_t = io.BytesIO(stdin), io.BytesIO(), io.StringIO()
    fake_in = io.TextIOWrapper(in_b, encoding="utf-8")
    fake_out = io.TextIOWrapper(out_b, encoding="utf-8", write_through=True)
    old = sys.stdin, sys.stdout, sys.stderr
    sys.stdin, sys.stdout, sys.stderr = fake_in, fake_out, err_t
    try:
        rc = jcli.main(list(argv))
    finally:
        fake_out.flush()
        sys.stdin, sys.stdout, sys.stderr = old
    return rc, out_b.getvalue(), err_t.getvalue()


def _payload() -> bytes:
    rng = np.random.default_rng(2222)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(512)]
    return b"".join(frags[i] for i in rng.integers(0, 512, 30000))[:150000]


def test_installed_console_tools_match_lz4tpu_cli(installed, tmp_path):
    import lz4tpu

    bin_dir = installed / "bin"
    for name in SCRIPTS:
        assert (bin_dir / name).is_file(), name
    payload = _payload()
    frame = lz4tpu.compress(payload, block_checksum=True)
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0x40
    path = tmp_path / "payload.bin"
    path.write_bytes(payload)
    cases = [("unlz4tpu-torch", ["unlz4"], frame),
             ("unlz4tpu-torch", ["unlz4"], bytes(bad)),
             ("unlz4tpu-simple-torch", ["unlz4-simple"], frame),
             ("lz4tpu-hdrinfo-torch", ["lz4hdrinfo"], frame),
             ("lz4tpu-xxhash32-torch", ["xxhash32"], payload)]
    for script, argv, stdin in cases:
        r = subprocess.run([str(bin_dir / script)], input=stdin,
                           cwd=tmp_path, env=_env(installed),
                           capture_output=True, timeout=120)
        want = _jax_cli(argv, stdin)
        assert (r.returncode, r.stdout, r.stderr.decode()) == want, script
    assert _jax_cli(["unlz4"], frame)[1] == payload
    assert _jax_cli(["unlz4"], bytes(bad))[0] == 1
    # the installed encoder's frame, decoded by the JAX package
    r = subprocess.run([str(bin_dir / "lz4tpu-compress-torch")],
                       input=payload, cwd=tmp_path, env=_env(installed),
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == _jax_cli(["lz4-compress"], payload)[1]
    assert lz4tpu.decompress(r.stdout) == payload


CARD = BLOCK + r'''
import pathlib
import torch
import lz4tpu_torch
from lz4tpu_torch import _kernels, pipeline
site = pathlib.Path(sys.argv[1]).resolve()
so = _kernels.build()
assert so.resolve() == site / "lz4tpu_torch" / "_build" / _kernels.LIB_NAME
payload = bytes(3_000_000) + open(pipeline.__file__, "rb").read()
frame = lz4tpu_torch.compress(payload, block_checksum=True)
_kernels.reset_launches()
out = lz4tpu_torch.decompress_to_device(frame, verify="device")
assert out.cpu().numpy().tobytes() == payload
assert sum(_kernels.LAUNCHES.values()) > 0, _kernels.LAUNCHES
assert pipeline.HOST_FALLBACKS == 0
print("card OK")
'''


@pytest.mark.cuda
def test_unpacked_tree_builds_its_kernels_on_the_card(unpacked, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    r = subprocess.run([sys.executable, "-c", CARD, str(unpacked)],
                       cwd=tmp_path, env=_env(unpacked), capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "card OK" in r.stdout
    assert (unpacked / "lz4tpu_torch" / "_build" / "nvcc.log").is_file()
