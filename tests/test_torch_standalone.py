"""lz4tpu_torch stands alone: with ``import jax`` and ``import lz4tpu``
both made to fail, the package imports, compresses, and decodes one
input per engine on the CPU, through the pipelined decode, the session
and the A/B harness's plain side too, encodes on the device path
(``device="cpu"``), runs its console tools and a round of its soak; no
file of it (nor ``chip_smoke.py``, nor the bench ``bench_torch/``)
imports either or reaches into ``lz4tpu/`` by path;
and its native engine is built from its own C++ source."""

import pathlib
import re
import subprocess
import sys

import lz4tpu_torch

PKG = pathlib.Path(lz4tpu_torch.__file__).resolve().parent
REPO = PKG.parent

SCRIPT = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now fails
sys.modules["lz4tpu"] = None         # and any `import lz4tpu`
import numpy as np
import lz4tpu_torch
import lz4tpu_torch.pipeline as pl
rng = np.random.default_rng(0)
frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                      dtype=np.uint8).tobytes() for _ in range(8192)]
text = b"".join(frags[i] for i in rng.integers(0, 8192, 30000))[:120000]
src = open(pl.__file__, "rb").read()[:80000]
for want, blob in (("sparse", bytes(600000)), ("fused", text),
                   ("dense", src)):
    data = lz4tpu_torch.compress(blob)
    buf = np.frombuffer(data, np.uint8)
    parsed = pl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    table = pl.build_seq_table(buf, parsed, lz4tpu_torch.FOR_ALL, data)
    st = pl.DecodeStats()
    pl.plan_decode(buf, parsed, table, st)
    assert st.engine_chains == {want: 1}, (want, st.engine_chains)
    out = lz4tpu_torch.decompress_to_device(data, device="cpu")
    assert out.numpy().tobytes() == blob, want
small = text[:20000]
data = lz4tpu_torch.compress(small, block_checksum=True, block_max_code=4)
out = lz4tpu_torch.decompress_to_device(data, device="cpu", verify="device")
assert out.numpy().tobytes() == small
for engine in ("auto", "pallas", "resolve"):
    assert lz4tpu_torch.decompress_device(
        data, engine=engine, device="cpu") == small, engine
assert lz4tpu_torch.decompress(data, backend="host") == small
# the pipelined decode, the session and the A/B harness's host side
out = lz4tpu_torch.decompress_to_device(
    lz4tpu_torch.compress(text), device="cpu", pipelined=True)
assert out.numpy().tobytes() == text
with lz4tpu_torch.DecodeSession(device="cpu") as s:
    tickets = [s.submit(lz4tpu_torch.compress(b)) for b in (text, src, b"")]
    assert [t.result() for t in tickets] == [text, src, b""]
    t = s.submit(data)
    assert t.result_on_device().numpy().tobytes() == small
import torch
from lz4tpu_torch.exp import ab
code, scal, n_out = ab.pack_host(lz4tpu_torch.compress(src), 3072)
rows, ring = ab.route_variant(torch.from_numpy(code), 3072)
assert rows.numpy()[:n_out].tobytes() == src
# the sharded decode over a repeated CPU device, every tier
from lz4tpu_torch import dist, spans
mesh = dist.make_mesh(4, "cpu")
for blob in (text, src, bytes(300000), text * 3):
    assert lz4tpu_torch.decompress_sharded(
        lz4tpu_torch.compress(blob), mesh) == blob
# the device encoder: both backends and the sharded encoder
for backend in ("device", "device-emit"):
    frame = lz4tpu_torch.compress(text, backend=backend, device="cpu",
                                  block_max_code=4)
    assert lz4tpu_torch.decompress(frame) == text, backend
assert dist.compress_sharded(text, mesh, block_max_code=4) == \
    lz4tpu_torch.compress(text, backend="device", device="cpu",
                          block_max_code=4)
# the console tools, in process
import io, os
from lz4tpu_torch import cli
os.environ[cli.DEVICE_ENV] = "cpu"
class _Out:
    def __init__(self):
        self.buffer = io.BytesIO()
    def write(self, s):
        self.buffer.write(s.encode())
    def flush(self):
        pass
class _In:
    def __init__(self, b):
        self.buffer = io.BytesIO(b)
sys.stdin, sys.stdout, sys.stderr = _In(data), _Out(), io.StringIO()
assert cli.main(["unlz4"]) == 0
got = sys.stdout.buffer.getvalue()
open(os.path.join(sys.argv[1], "t.bin"), "wb").write(text[:9000])
sys.stdout = _Out()
assert cli.main(["lz4-bench", "--encode", "--backend", "device",
                 "--reps", "1", os.path.join(sys.argv[1], "t.bin")]) == 0
sys.stdin, sys.stdout, sys.stderr = sys.__stdin__, sys.__stdout__, \
    sys.__stderr__
assert got == small
# one round of the soak: every device path, corruptions, the encoder
from lz4tpu_torch.exp import soak
cover = soak.one_round(np.random.default_rng(0), 0, "cpu")
assert cover.rounds == 1 and cover.encoded == 2
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert "jax" not in loaded and "lz4tpu" not in loaded
print("standalone OK")
"""


def test_decodes_every_engine_with_jax_blocked(tmp_path):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "standalone OK" in r.stdout


def _port_files():
    files = (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "bench_torch").glob("*.py")))
    assert len(files) >= 26
    names = {str(f.relative_to(REPO)) for f in files}
    assert {"lz4tpu_torch/serve.py", "lz4tpu_torch/exp/ab.py",
            "lz4tpu_torch/exp/__init__.py", "lz4tpu_torch/exp/soak.py",
            "lz4tpu_torch/spans.py",
            "lz4tpu_torch/dist.py", "lz4tpu_torch/device/encode.py",
            "lz4tpu_torch/cli.py", "chip_smoke.py",
            "bench_torch/__main__.py", "bench_torch/corpora.py",
            "bench_torch/run.py", "bench_torch/spread.py"} <= names
    return files


def test_no_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])|__import__\(.jax",
                     re.M)
    for f in _port_files():
        assert not pat.search(f.read_text()), f


def test_no_file_imports_lz4tpu():
    pat = re.compile(
        r"^\s*(import\s+lz4tpu|from\s+lz4tpu)([\s.,]|$)"
        r"|__import__\(.lz4tpu[\"'.]|import_module\(.lz4tpu[\"'.]", re.M)
    for f in _port_files():
        assert not pat.search(f.read_text()), f


def test_no_file_reaches_into_lz4tpu_by_path():
    # a path into the JAX package: "lz4tpu/..." in a string that is
    # opened, joined or globbed (docstrings that cite a file and line of
    # the kernel a module replaces are not paths the code follows)
    pat = re.compile(r"""(open|Path|join|glob|exists)\([^)\n]*["']"""
                     r"""[^"'\n]*\blz4tpu[/"']""")
    for f in _port_files():
        assert not pat.search(f.read_text()), f
    from lz4tpu_torch import native

    assert pathlib.Path(native._SRC) == PKG / "native" / "lz4core.cpp"
    assert pathlib.Path(native._SO).parent == PKG / "native"
    assert (PKG / "native" / "lz4core.cpp").is_file()


def test_sharded_decode_modules_import_only_torch_numpy_and_the_port():
    """spans.py, dist.py (a file: ``dist/`` is git-ignored), the device
    encoder and the CLI import the standard library, numpy, torch and
    the port's own modules."""
    import ast

    allowed = {"__future__", "argparse", "concurrent", "contextlib",
               "dataclasses", "numpy", "os", "struct", "sys", "time",
               "torch"}
    for name in ("spans.py", "dist.py", "device/encode.py", "cli.py"):
        path = PKG / name
        assert path.is_file()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:          # from . / from .. : the port
                    continue
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, (name, m)


def test_no_file_imports_the_tpu_experiments():
    # exp/ at the root is the JAX package's harness directory; the
    # port's own is lz4tpu_torch/exp
    pat = re.compile(r"^\s*(import\s+exp|from\s+exp)([\s.]|$)", re.M)
    for f in _port_files():
        assert not pat.search(f.read_text()), f


def test_decode_session_is_exported_lazily():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, lz4tpu_torch\n"
         "assert 'lz4tpu_torch.serve' not in sys.modules\n"
         "assert 'DecodeSession' not in vars(lz4tpu_torch)\n"
         "cls = lz4tpu_torch.DecodeSession\n"
         "import lz4tpu_torch.serve\n"
         "assert cls is lz4tpu_torch.serve.DecodeSession\n"
         "assert vars(lz4tpu_torch)['DecodeSession'] is cls\n"
         "try:\n    lz4tpu_torch.nothing_here\n"
         "except AttributeError as e:\n    assert 'nothing_here' in str(e)\n"
         "else:\n    raise SystemExit('no AttributeError')\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_exports_match_the_jax_package():
    import lz4tpu

    ours = set(lz4tpu_torch.__all__)
    for name in lz4tpu.__all__:
        assert name in ours, name
        assert hasattr(lz4tpu_torch, name), name
    for name in ("decompress_device", "decompress_into", "min_buffer_size",
                 "hex8", "hex32"):
        assert name in ours
