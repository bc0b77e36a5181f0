"""lz4tpu_torch mxu2 engine held against lz4tpu.device.mxu2 on the CPU.

The port's packer must emit the JAX package's routing codes, and its
plain PyTorch decode (the CPU side of kernel H3) must equal the Pallas
kernel run in interpret mode, ring carry included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu
from lz4tpu import FOR_ALL
from lz4tpu.device import fused as jfu
from lz4tpu.device import mxu2 as jmx
from lz4tpu.frame import parse_frames
from lz4tpu.pipeline import _chains_of, build_seq_table
from lz4tpu_torch import _kernels
from lz4tpu_torch.device import mxu2 as tmx
from lz4tpu_torch.device.ring import (
    part_segments,
    ring_from_jax,
    segments_tensor,
)


def _src_text(n: int) -> bytes:
    """The JAX package's own source text: dense in-substep references,
    the shape that overflows the fused engine."""
    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (jmx, lz4tpu.pipeline, lz4tpu.api, jfu))
    assert len(blob) >= n
    return blob[:n]


def _packs(data: bytes, per_chain: bool = False):
    buf = np.frombuffer(data, np.uint8)
    t = build_seq_table(buf, parse_frames(buf, FOR_ALL), FOR_ALL, data)
    ranges = ([(c.seq_lo, c.seq_hi) for c in _chains_of(t)]
              if per_chain else None)
    cols = (t.lit_len, t.match_len, t.match_off, t.lit_src, buf)
    return (tmx.pack_dense2(*cols, chain_ranges=ranges),
            jmx.pack_dense2(*cols, chain_ranges=ranges))


def _single():
    blob = _src_text(96 << 10)
    return (blob,) + _packs(lz4tpu.compress(blob))


def _multi():
    rng = np.random.default_rng(2)
    blob = (_src_text(80 << 10)
            + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
            + b"\x07" * 40000)
    data = lz4tpu.compress(blob, block_max_code=4, block_independence=True)
    return (blob,) + _packs(data, per_chain=True)


def _spans_bytes(flat, pack):
    return b"".join(flat[slo * tmx.SUB: slo * tmx.SUB + n].tobytes()
                    for (_c, slo, _shi, n) in pack.out_spans)


@pytest.mark.parametrize("make", [_single, _multi], ids=["one", "chains"])
def test_pack_codes_match_jax(make):
    _blob, pt, pj = make()
    assert pt.n_sub == pj.n_sub >= 20
    assert np.array_equal(pt.code, pj.code)
    assert np.array_equal(pt.scal, pj.scal)
    assert pt.out_spans == pj.out_spans
    port = tmx.pack_from_numpy(pj)
    assert np.array_equal(port.code, pj.code)
    assert not np.shares_memory(port.code, pj.code)


@pytest.mark.parametrize("make", [_single, _multi], ids=["one", "chains"])
def test_plain_decode_matches_pallas(make):
    blob, pt, pj = make()
    rows, _ring = tmx.decode_dense2_rows(pt, "cpu")
    ref = jmx.decode_dense2_rows(pj, interpret=True)
    assert np.array_equal(rows.numpy(), ref)
    assert _spans_bytes(rows.numpy(), pt) == blob


def test_ring_carry_across_two_part_split():
    blob, pt, pj = _single()
    cut = pj.n_sub // 2
    rows1_j, ring_j = jmx._decode_dense2_device(
        jnp.asarray(pj.code[:cut]), jnp.asarray(pj.scal[:cut]),
        n_sub=cut, interpret=True)
    rows2_j, _ = jmx._decode_dense2_device(
        jnp.asarray(pj.code[cut:]), jnp.asarray(pj.scal[cut:]), ring_j,
        n_sub=pj.n_sub - cut, interpret=True)

    def port_part(lo, hi, ring=None):
        segs = segments_tensor(
            part_segments(pt.out_spans, lo, hi, ring is not None), "cpu")
        return tmx.route(torch.from_numpy(pt.code[lo:hi]),
                         torch.from_numpy(pt.scal[lo:hi]), segs, ring)

    rows1, ring1 = port_part(0, cut)
    assert torch.equal(ring1, ring_from_jax(ring_j))
    rows2, _ = port_part(cut, pt.n_sub, ring_from_jax(ring_j))
    assert np.array_equal(rows1.numpy(), np.asarray(rows1_j).reshape(-1))
    assert np.array_equal(rows2.numpy(), np.asarray(rows2_j).reshape(-1))
    whole = np.concatenate([rows1.numpy(), rows2.numpy()])
    assert whole[:len(blob)].tobytes() == blob


@pytest.mark.parametrize("make", [_single, _multi], ids=["one", "chains"])
def test_partwise_rows_match_jax_part_subs(make):
    blob, pt, pj = make()
    rows, _ = tmx.decode_dense2_rows(pt, "cpu", part_subs=5)
    ref = jmx.decode_dense2_rows(pj, interpret=True, part_subs=5)
    assert np.array_equal(rows.numpy(), ref)
    assert _spans_bytes(rows.numpy(), pt) == blob


def test_ring_in_matches_jax_ring_init():
    """A seeded ring reaches the first chain as the Pallas kernel's
    ring_in does."""
    _blob, pt, pj = _single()
    rng = np.random.default_rng(9)
    seed = rng.integers(0, 256, 65536, dtype=np.uint8)
    ring_j = jnp.asarray(seed.reshape(256, 256).astype(np.float32),
                         jnp.bfloat16)
    ref = jmx.decode_dense2_rows(pj, interpret=True, ring_init=ring_j)
    rows, _ = tmx.decode_dense2_rows(pt, "cpu", ring_in=ring_from_jax(
        jax.device_get(ring_j)))
    assert np.array_equal(rows.numpy(), ref)


def test_cpu_route_launches_nothing():
    _blob, pt, _ = _single()
    before = dict(_kernels.LAUNCHES)
    tmx.decode_dense2_rows(pt, "cpu")
    assert _kernels.LAUNCHES == before


def test_empty_pack():
    z = np.zeros(0, np.int32)
    pack = tmx.pack_dense2(z, z, np.ones(0, np.int32), z,
                           np.zeros(0, np.uint8))
    assert pack.n_sub == 0 and pack.out_spans == [(0, 0, 0, 0)]
    rows, ring = tmx.decode_dense2_rows(pack, "cpu")
    assert rows.numel() == 0 and ring.shape == (65536,)
