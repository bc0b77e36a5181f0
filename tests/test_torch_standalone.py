"""lz4tpu_torch stands alone: with ``import jax`` and ``import lz4tpu``
both made to fail, the package imports, compresses, and decodes one
input per engine on the CPU; no file of it (nor ``chip_smoke.py``)
imports either or reaches into ``lz4tpu/`` by path; and its native
engine is built from its own C++ source."""

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
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert "jax" not in loaded and "lz4tpu" not in loaded
print("standalone OK")
"""


def test_decodes_every_engine_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "standalone OK" in r.stdout


def _port_files():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 18
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


def test_exports_match_the_jax_package():
    import lz4tpu

    ours = set(lz4tpu_torch.__all__)
    for name in lz4tpu.__all__:
        if name != "__version__":
            assert name in ours, name
            assert hasattr(lz4tpu_torch, name), name
    for name in ("decompress_device", "decompress_into", "min_buffer_size",
                 "hex8", "hex32"):
        assert name in ours
