"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU with ``nvcc`` (kernels build at first use); every
test here is marked ``cuda`` and skips without one.  On the card:
``python -m pytest tests/test_torch_kernels.py -q``; ``chip_smoke.py``
runs the same comparisons at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
from lz4tpu import FOR_ALL
from lz4tpu.device import fused as jfu
from lz4tpu_torch import _kernels
from lz4tpu_torch.device import fused as tfu
from lz4tpu_torch.device import mxu2 as tmx
from lz4tpu_torch.device import sparse_decode as tsp
from lz4tpu_torch.device.ring import part_segments, segments_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    return b"".join(frags[i] for i in rng.integers(0, 8192, n // 5 + 16))[:n]


def _src_text(n: int) -> bytes:
    return b"".join(open(m.__file__, "rb").read()
                    for m in (jfu, jpl, lz4tpu.api))[:n]


def _table(data):
    buf = np.frombuffer(data, np.uint8)
    t = jpl.build_seq_table(buf, jpl.parse_frames(buf, FOR_ALL), FOR_ALL,
                            data)
    ranges = [(c.seq_lo, c.seq_hi) for c in jpl._chains_of(t)]
    return (t.lit_len, t.match_len, t.match_off, t.lit_src, buf), ranges


def test_block_fill_kernel(cuda):
    vals = torch.tensor([0, 1, 255, 300, -1, 9], dtype=torch.int32)
    n0 = _kernels.LAUNCHES["block_fill"]
    got = tsp.block_fill(vals.to(cuda))
    assert _kernels.LAUNCHES["block_fill"] == n0 + 1
    assert torch.equal(got.cpu(), tsp.block_fill_plain(vals))


@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("part_subs", [None, 13])
def test_fused_kernels(cuda, independent, part_subs):
    kw = dict(block_max_code=4, block_independence=True) if independent \
        else {}
    cols, ranges = _table(lz4tpu.compress(_frag_text(600_000, 11), **kw))
    prep = tfu.prep_fused(*cols, chain_ranges=ranges, pooled=False)
    rng = np.random.default_rng(1)
    seed = torch.from_numpy(rng.integers(0, 256, 65536, dtype=np.uint8))
    n = prep.n_sub
    t = {k: torch.from_numpy(np.ascontiguousarray(getattr(prep, k)[:n]))
         for k in ("seqrec", "scal", "patch", "winq")}
    pos_k = tfu.expand(*(t[k].to(cuda) for k in ("seqrec", "scal",
                                                  "patch")))
    pos_p = tfu.expand_plain(t["seqrec"], t["scal"], t["patch"])
    assert torch.equal(pos_k.cpu(), pos_p)
    rows_k, ring_k = tfu.decode_fused_rows(prep, cuda, ring_in=seed.to(cuda),
                                           part_subs=part_subs)
    rows_p, ring_p = tfu.decode_fused_rows(prep, "cpu", ring_in=seed,
                                           part_subs=part_subs)
    torch.cuda.synchronize()
    assert torch.equal(rows_k.cpu(), rows_p)
    assert torch.equal(ring_k.cpu(), ring_p)


@pytest.mark.parametrize("independent", [False, True])
def test_mxu2_kernel(cuda, independent):
    kw = dict(block_max_code=4, block_independence=True) if independent \
        else {}
    cols, ranges = _table(lz4tpu.compress(_src_text(300_000), **kw))
    pack = tmx.pack_dense2(*cols, chain_ranges=ranges)
    segs = part_segments(pack.out_spans, 0, pack.n_sub, False)
    code, scal = torch.from_numpy(pack.code), torch.from_numpy(pack.scal)
    rows_k, ring_k = tmx.route(code.to(cuda), scal.to(cuda),
                               segments_tensor(segs, cuda))
    rows_p, ring_p = tmx.route_plain(code, scal, segments_tensor(segs, "cpu"))
    torch.cuda.synchronize()
    assert torch.equal(rows_k.cpu(), rows_p)
    assert torch.equal(ring_k.cpu(), ring_p)


@pytest.mark.parametrize("kind", ["zeros", "fused", "mxu2"])
def test_decompress_to_device_on_card(cuda, kind):
    blob = {"zeros": bytes(3_000_000), "fused": _frag_text(400_000, 3),
            "mxu2": _src_text(200_000)}[kind]
    counter = {"zeros": "block_fill", "fused": "fused_route",
               "mxu2": "mxu2_route"}[kind]
    n0 = _kernels.LAUNCHES[counter]
    out = lz4tpu_torch.decompress_to_device(lz4tpu.compress(blob))
    assert out.is_cuda
    assert out.cpu().numpy().tobytes() == blob
    assert _kernels.LAUNCHES[counter] > n0


@pytest.mark.parametrize("seed", range(4))
def test_card_equals_plain_on_mixed_frames(cuda, seed):
    """Frames mixing every engine, with random options, decode to the
    same bytes on the card as through the plain versions."""
    rng = np.random.default_rng(900 + seed)
    parts = [bytes(int(rng.integers(1, 2_000_000))),
             _frag_text(int(rng.integers(1, 700_000)), seed),
             _src_text(int(rng.integers(1, 200_000))),
             rng.integers(0, 256, int(rng.integers(1, 300_000)),
                          np.uint8).tobytes()]
    order = rng.permutation(len(parts))
    blob = b"".join(parts[i] for i in order)
    data = lz4tpu.compress(blob, block_max_code=int(rng.integers(4, 8)),
                           block_independence=bool(rng.integers(0, 2)))
    out = lz4tpu_torch.decompress_to_device(data)
    plain = lz4tpu_torch.decompress_to_device(data, device="cpu")
    assert torch.equal(out.cpu(), plain)
    assert plain.numpy().tobytes() == blob


def test_kernel_rejects_cpu_mix(cuda):
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmx.route(torch.zeros((1, 2048), dtype=torch.int32, device=cuda),
                  torch.zeros((1, 1), dtype=torch.int32),
                  torch.zeros((1, 3), dtype=torch.int32, device=cuda))
