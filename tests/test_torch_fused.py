"""lz4tpu_torch fused engine held against lz4tpu.device.fused on the CPU.

The port's host prep must produce the JAX package's arrays byte for
byte (they are the host-to-kernel contract), and its plain PyTorch
decode (the CPU side of kernel H1) must equal ``golden_decode`` and the
Pallas kernel run in interpret mode, ring carry included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu
from lz4tpu import FOR_ALL
from lz4tpu.device import fused as jfu
from lz4tpu.frame import parse_frames
from lz4tpu.pipeline import _chains_of, build_seq_table
from lz4tpu_torch import _kernels
from lz4tpu_torch.device import fused as tfu
from lz4tpu_torch.device.ring import (
    part_segments,
    ring_from_jax,
    ring_to_jax,
    segments_tensor,
)


def _frag_text(n: int, seed: int, n_frag: int = 8192, lo: int = 3,
               hi: int = 8) -> bytes:
    """Printable text drawn from a seeded fragment dictionary: stays
    within the fused engine's in-substep patch budget."""
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(lo, hi + 1)),
                          dtype=np.uint8).tobytes() for _ in range(n_frag)]
    mean = np.mean([len(f) for f in frags])
    picks = rng.integers(0, n_frag, int(n / mean * 1.1) + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _table(data: bytes, pooled_cols: bool = False):
    buf = np.frombuffer(data, np.uint8)
    parsed = parse_frames(buf, FOR_ALL)
    return buf, build_seq_table(buf, parsed, FOR_ALL, data,
                                pooled_cols=pooled_cols)


def _cols(t):
    return t.lit_len, t.match_len, t.match_off, t.lit_src


def _assert_prep_equal(a, b):
    n = a.n_sub
    assert n == b.n_sub
    for name in ("seqrec", "winq", "scal", "patch"):
        assert np.array_equal(getattr(a, name)[:n], getattr(b, name)[:n]), name
    assert np.array_equal(a.lits, b.lits)
    for f in ("n_patches", "n_seq_recs", "out_spans", "max_off",
              "max_recs", "max_patches"):
        assert getattr(a, f) == getattr(b, f), f


def _single(n=128 << 10, seed=11):
    blob = _frag_text(n, seed)
    data = lz4tpu.compress(blob)
    buf, t = _table(data, pooled_cols=True)
    assert t.pre is not None
    kw = dict(pre=t.pre, pooled=False)
    prep_t = tfu.prep_fused(*_cols(t), buf, **kw)
    prep_j = jfu.prep_fused(*_cols(t), buf, **kw)
    return blob, prep_t, prep_j


def _multi():
    blob = _frag_text(192 << 10, 5)
    data = lz4tpu.compress(blob, block_max_code=4, block_independence=True)
    buf, t = _table(data)
    ranges = [(c.seq_lo, c.seq_hi) for c in _chains_of(t)]
    assert len(ranges) == 3
    prep_t = tfu.prep_fused(*_cols(t), buf, chain_ranges=ranges,
                            pooled=False)
    prep_j = jfu.prep_fused(*_cols(t), buf, chain_ranges=ranges,
                            pooled=False)
    return blob, prep_t, prep_j


def _rows(prep, **kw):
    rows, ring = tfu.decode_fused_rows(prep, "cpu", **kw)
    return rows.numpy(), ring


def _spans_bytes(flat, prep):
    return b"".join(flat[slo * tfu.SUB: slo * tfu.SUB + n].tobytes()
                    for (_c, slo, _shi, n) in prep.out_spans)


@pytest.mark.parametrize("make", [_single, _multi], ids=["pre", "chains"])
def test_prep_arrays_match_jax(make):
    _blob, prep_t, prep_j = make()
    assert prep_t.n_sub >= 32
    _assert_prep_equal(prep_t, prep_j)


def test_prep_from_numpy_copies():
    _blob, _prep_t, prep_j = _single(32 << 10)
    port = tfu.prep_from_numpy(prep_j)
    _assert_prep_equal(port, prep_j)
    assert not np.shares_memory(port.seqrec, prep_j.seqrec)


@pytest.mark.parametrize("payload", ["src", "rle7"])
def test_overflow_raised_on_same_inputs(payload):
    if payload == "src":
        blob = open(jfu.__file__, "rb").read()[:128 << 10]
    else:
        blob = b"abcdefg" * 20000
    buf, t = _table(lz4tpu.compress(blob))
    with pytest.raises(jfu.FusedOverflow):
        jfu.prep_fused(*_cols(t), buf, pooled=False)
    with pytest.raises(tfu.FusedOverflow):
        tfu.prep_fused(*_cols(t), buf, pooled=False)


@pytest.mark.parametrize("make", [_single, _multi], ids=["pre", "chains"])
def test_plain_decode_matches_golden_and_pallas(make):
    blob, prep_t, prep_j = make()
    flat, _ring = _rows(prep_t)
    golden = jfu.golden_decode(prep_j)
    pallas = np.asarray(jax.device_get(
        jfu.decode_fused_rows_on_device(prep_j, interpret=True)))
    assert np.array_equal(flat, golden)
    assert np.array_equal(flat, pallas)
    assert _spans_bytes(flat, prep_t) == blob


def test_expand_plain_sources_in_range():
    """Every pos17 is a ring position (< 65536) or lies in the 4 KiB
    literal window above it."""
    _blob, prep_t, _ = _single(64 << 10)
    n = prep_t.n_sub
    pos = tfu.expand(torch.from_numpy(prep_t.seqrec[:n]),
                     torch.from_numpy(prep_t.scal[:n]),
                     torch.from_numpy(prep_t.patch[:n]))
    assert pos.shape == (n, tfu.SUB) and pos.dtype == torch.int32
    assert int(pos.min()) >= 0 and int(pos.max()) < 65536 + 4096


def test_ring_carry_across_two_part_split():
    blob, prep_t, prep_j = _single()
    n = prep_t.n_sub
    cut = n // 2
    args = [jnp.asarray(a[:n]) for a in (prep_j.seqrec, prep_j.lits,
                                         prep_j.winq, prep_j.scal,
                                         prep_j.patch)]
    args[1] = jnp.asarray(prep_j.lits)

    def part(lo, hi, ring=None):
        a = [x if k == 1 else x[lo:hi] for k, x in enumerate(args)]
        return jfu._decode_fused_device(*a, ring, n_sub=hi - lo,
                                        interpret=True)

    rows1_j, ring_j = part(0, cut)
    rows2_j, _ = part(cut, n, ring_j)

    t = {k: torch.from_numpy(np.ascontiguousarray(getattr(prep_t, k)[:n]))
         for k in ("seqrec", "winq", "scal", "patch")}
    lits = torch.from_numpy(prep_t.lits)

    def port_part(lo, hi, ring=None):
        segs = segments_tensor(
            part_segments(prep_t.out_spans, lo, hi, ring is not None), "cpu")
        pos = tfu.expand(t["seqrec"][lo:hi], t["scal"][lo:hi],
                         t["patch"][lo:hi])
        return tfu.route(pos, lits, t["winq"][lo:hi], t["scal"][lo:hi],
                         segs, ring)

    rows1, ring1 = port_part(0, cut)
    assert torch.equal(ring1, ring_from_jax(ring_j))
    assert np.array_equal(ring_to_jax(ring1),
                          np.asarray(ring_j, np.float32))
    rows2, _ = port_part(cut, n, ring_from_jax(ring_j))
    assert np.array_equal(rows1.numpy(), np.asarray(rows1_j).reshape(-1))
    assert np.array_equal(rows2.numpy(), np.asarray(rows2_j).reshape(-1))
    whole = np.concatenate([rows1.numpy(), rows2.numpy()])
    assert whole[:len(blob)].tobytes() == blob


@pytest.mark.parametrize("make", [_single, _multi], ids=["pre", "chains"])
def test_partwise_rows_match_jax_part_subs(make):
    blob, prep_t, prep_j = make()
    flat, _ = _rows(prep_t, part_subs=7)
    ref = np.asarray(jax.device_get(jfu.decode_fused_rows_on_device(
        prep_j, interpret=True, part_subs=7)))
    assert np.array_equal(flat, ref)
    assert _spans_bytes(flat, prep_t) == blob


def test_ring_in_seeds_first_chain():
    """A seeded ring is read by the first chain exactly as
    golden_decode's ring_init (garbage history in, same bytes out)."""
    _blob, prep_t, prep_j = _single(32 << 10)
    rng = np.random.default_rng(3)
    seed = rng.integers(0, 256, 65536, dtype=np.uint8)
    flat, ring = _rows(prep_t, ring_in=torch.from_numpy(seed.copy()))
    assert np.array_equal(flat, jfu.golden_decode(prep_j, ring_init=seed))


def test_cpu_wrappers_launch_nothing():
    _blob, prep_t, _ = _single(16 << 10)
    before = dict(_kernels.LAUNCHES)
    _rows(prep_t)
    assert _kernels.LAUNCHES == before


def test_empty_prep():
    prep = tfu.FusedPrep(**{
        **{f.name: None for f in dataclasses.fields(tfu.FusedPrep)},
        "n_sub": 0, "n_patches": 0, "n_seq_recs": 0, "out_spans": [],
    })
    rows, ring = tfu.decode_fused_rows(prep, "cpu")
    assert rows.numel() == 0 and ring.shape == (65536,)


@pytest.mark.parametrize("seeded", [False, True], ids=["zero_ring", "seeded"])
def test_decode_split_matches_jax_split_kernels(seeded):
    """The port's two-launch decode against the JAX package's expansion
    and routing kernels (``_decode_split_device``, interpret mode): rows
    and final ring, from a zero ring and from a seeded one."""
    blob, prep_t, prep_j = _single(48 << 10, seed=21)
    n = prep_j.n_sub
    seed = np.random.default_rng(4).integers(0, 256, 65536, dtype=np.uint8)
    ring_j = (jnp.asarray(seed.reshape(256, 256).astype(np.float32),
                          jnp.bfloat16) if seeded else None)
    rows_j, ring_out_j = jfu._decode_split_device(
        *(jnp.asarray(x) for x in (prep_j.seqrec, prep_j.lits, prep_j.winq,
                                   prep_j.scal, prep_j.patch)),
        ring_j, n_sub=n, interpret=True)
    rows_t, ring_out_t = tfu.decode_split(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (
            prep_t.seqrec, prep_t.lits, prep_t.winq, prep_t.scal,
            prep_t.patch)),
        torch.from_numpy(seed.copy()) if seeded else None, n_sub=n)
    flat_j = np.asarray(jax.device_get(rows_j)).reshape(-1)
    assert rows_t.dtype == torch.uint8 and rows_t.shape == (n * tfu.SUB,)
    assert np.array_equal(rows_t.numpy(), flat_j)
    assert torch.equal(ring_out_t, ring_from_jax(ring_out_j))
    assert rows_t.numpy()[:len(blob)].tobytes() == blob
