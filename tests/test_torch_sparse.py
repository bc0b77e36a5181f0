"""lz4tpu_torch sparse engine held against lz4tpu.device.sparse_decode.

The block fill's plain PyTorch version (the CPU side of kernel H2) must
equal the Pallas fill (interpret mode on the CPU), and the torch program
executor must equal ``decode_sparse`` on every program shape: block
fill with patches, hole-free concatenation, and in-order copy / fill /
self.
"""

import numpy as np
import pytest
import torch

import lz4tpu
from lz4tpu import FOR_ALL
from lz4tpu.device import sparse_decode as jsp
from lz4tpu.frame import parse_frames
from lz4tpu.pipeline import _chains_of, build_seq_table
from lz4tpu_torch import _kernels
from lz4tpu_torch.device import sparse_decode as tsp


def _program(blob: bytes, **kw):
    data = lz4tpu.compress(blob, **kw)
    buf = np.frombuffer(data, np.uint8)
    t = build_seq_table(buf, parse_frames(buf, FOR_ALL), FOR_ALL, data)
    (chain,) = _chains_of(t)
    sl = slice(chain.seq_lo, chain.seq_hi)
    prog = tsp.build_sparse_program(
        t.lit_len[sl], t.match_len[sl], t.match_off[sl], t.lit_src[sl], buf)
    assert prog is not None
    return prog, buf


def _rand(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("vals", [[0], [1, 2, 300], [-1, 255, 7, 0]])
def test_block_fill_plain_matches_pallas(vals):
    v = np.array(vals, np.int32)
    ref = np.asarray(jsp._block_fill(v.reshape(-1, 1)))
    got = tsp.block_fill(torch.from_numpy(v))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), ref)


CASES = {
    # zeros: one uniform fill -> block-fill plan with byte patches
    "zeros": (lambda: bytes(1_500_000), {}, "fill"),
    # an RLE byte run bracketed by text: block fill + copy patches
    "rle": (lambda: b"head" + b"\x05" * 1_200_000 + _rand(300, 1), {},
            "fill"),
    # incompressible: stored blocks -> hole-free concatenation
    "stored": (lambda: _rand(300_000, 2), {}, "concat"),
    # a non-uniform small-offset pattern -> tiled fill, concatenation
    "pattern": (lambda: _rand(20, 3) + b"abc" * 30_000, {}, "concat"),
    # a far repeat and a self-overlapping repeat -> 'self' ops
    "self": (lambda: (_rand(1000, 4) * 2) + _rand(100, 5) * 12, {},
             "self"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_matches_jax(name):
    make, kw, shape = CASES[name]
    blob = make()
    prog, buf = _program(blob, **kw)
    kinds = {op.kind for op in prog.ops}
    plan = jsp._plan_block_fill(prog.ops, prog.n_out)
    if shape == "fill":
        assert plan is not None
    elif shape == "concat":
        assert plan is None and "self" not in kinds
    else:
        assert "self" in kinds
    got = tsp.decode_sparse(prog, buf, device="cpu")
    assert got == jsp.decode_sparse(prog, buf) == blob


def test_cpu_fill_launches_nothing():
    before = dict(_kernels.LAUNCHES)
    tsp.block_fill(torch.tensor([3], dtype=torch.int32))
    assert _kernels.LAUNCHES == before


def test_decode_sparse_defaults_to_the_card():
    """Like every entry point that takes ``device=``: the default is
    ``"cuda"``, and without CUDA it raises and does not carry on on the
    CPU."""
    import inspect

    assert (inspect.signature(tsp.decode_sparse).parameters["device"].default
            == "cuda")
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is absent")
    prog, buf = _program(bytes(100_000))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsp.decode_sparse(prog, buf)
