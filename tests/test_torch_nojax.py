"""lz4tpu_torch runs where JAX is not installed (the GPU machine has
none): with ``import jax`` made to fail, the package imports and decodes
one input per engine on the CPU, and no file of it imports jax."""

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
import numpy as np
import lz4tpu, lz4tpu_torch
import lz4tpu.pipeline as pl
from lz4tpu.device import sparse_decode
rng = np.random.default_rng(0)
frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                      dtype=np.uint8).tobytes() for _ in range(8192)]
text = b"".join(frags[i] for i in rng.integers(0, 8192, 30000))[:120000]
src = open(pl.__file__, "rb").read()[:80000]
for want, blob in (("sparse", bytes(600000)), ("fused", text),
                   ("dense", src)):
    data = lz4tpu.compress(blob)
    buf = np.frombuffer(data, np.uint8)
    parsed = pl.parse_frames(buf, lz4tpu.FOR_ALL)
    table = pl.build_seq_table(buf, parsed, lz4tpu.FOR_ALL, data)
    st = pl.DecodeStats()
    lz4tpu_torch.pipeline.plan_decode(buf, parsed, table, st)
    assert st.engine_chains == {want: 1}, (want, st.engine_chains)
    out = lz4tpu_torch.decompress_to_device(data, device="cpu")
    assert out.numpy().tobytes() == blob, want
assert "jax" not in {m.split(".")[0] for m, v in sys.modules.items()
                     if v is not None}
print("nojax OK")
"""


def test_decodes_every_engine_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "nojax OK" in r.stdout


def test_no_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])|__import__\(.jax",
                     re.M)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 8
    for f in files:
        assert not pat.search(f.read_text()), f
