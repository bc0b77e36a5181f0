"""lz4tpu_torch mxu2 engine held against lz4tpu.device.mxu2 on the CPU.

The port's packer must emit the JAX package's routing codes, and its
plain PyTorch decode (the CPU side of kernel H3) must equal the Pallas
kernel run in interpret mode, ring carry included.
"""

import re

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
from lz4tpu_torch.exp import edge


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


def _words(n: int) -> bytes:
    """n bytes of word tokens (words, punctuation runs, white-space
    runs) of the JAX package's source text, drawn with a seeded
    generator: one dense chain with deep reference chains."""
    toks = sorted(set(re.findall(
        rb"[A-Za-z_][A-Za-z0-9_]*|[^A-Za-z0-9_\s]+|\s+", _src_text(140_000))))
    rng = np.random.default_rng(5)
    out = b"".join([toks[i] for i in rng.integers(0, len(toks), n // 3)])
    assert len(out) >= n
    return out[:n]


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
        return tmx._route(torch.from_numpy(pt.code[lo:hi]),
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


# ---------------------------------------------------------------------------
# kernel H3's steps in plain PyTorch: the sources pass and pointer jumping
# ---------------------------------------------------------------------------

def _segs(pack, lo=0, hi=None, seeded=False):
    hi = pack.n_sub if hi is None else hi
    return segments_tensor(part_segments(pack.out_spans, lo, hi, seeded),
                           "cpu")


def _jump_rows(pack, part_subs=None, ring_in=None):
    """decode_dense2_rows's part loop through route_jump_plain."""
    n, part = pack.n_sub, part_subs or tmx.PART_SUBS
    rows, ring = [], ring_in
    for p0 in range(0, n, part):
        p1 = min(p0 + part, n)
        r, ring = tmx.route_jump_plain(
            torch.from_numpy(pack.code[p0:p1]),
            torch.from_numpy(pack.scal[p0:p1]),
            _segs(pack, p0, p1, ring_in is not None), ring)
        rows.append(r)
    return torch.cat(rows), ring


@pytest.mark.parametrize("make", [_single, _multi], ids=["one", "chains"])
def test_sources_pass_names_each_bytes_source(make):
    """Pass 0: a known byte is resolved to its value; a ring reference
    points at a byte of an earlier substep of its own chain, and the
    decoded byte there is the byte itself."""
    blob, pt, _pj = make()
    code = torch.from_numpy(pt.code)
    state = tmx.sources_plain(code, torch.from_numpy(pt.scal), _segs(pt))
    rows, _ = tmx.route_plain(code, torch.from_numpy(pt.scal), _segs(pt))
    known = ((code >> 16) & 1).reshape(-1) == 0
    assert torch.equal(~state[known], ((code >> 17) & 255).reshape(-1)[known])
    ptr = state >= 0
    assert 0.5 < float(ptr.float().mean()) < 1.0
    own = torch.arange(state.numel()) // tmx.SUB
    for (_c, lo, hi, _n) in pt.out_spans:
        mine = ptr & (own >= lo) & (own < hi)
        target = state[mine].to(torch.int64) // tmx.SUB
        assert bool((target < own[mine]).all() and (target >= lo).all())
    assert torch.equal(rows[state[ptr].to(torch.int64)], rows[ptr])


@pytest.mark.parametrize("make", [_single, _multi], ids=["one", "chains"])
def test_pointer_jumping_matches_serial_and_pallas(make):
    blob, pt, pj = make()
    code, scal = torch.from_numpy(pt.code), torch.from_numpy(pt.scal)
    rows, ring = tmx.route_jump_plain(code, scal, _segs(pt))
    rows_s, ring_s = tmx.route_plain(code, scal, _segs(pt))
    assert torch.equal(rows, rows_s) and torch.equal(ring, ring_s)
    ref = jmx.decode_dense2_rows(pj, interpret=True)
    assert np.array_equal(rows.numpy(), ref)
    assert _spans_bytes(rows.numpy(), pt) == blob


def test_pointer_jumping_ring_carry_across_two_part_split():
    blob, pt, pj = _single()
    cut = pj.n_sub // 2
    rows1_j, ring_j = jmx._decode_dense2_device(
        jnp.asarray(pj.code[:cut]), jnp.asarray(pj.scal[:cut]),
        n_sub=cut, interpret=True)
    rows2_j, ring2_j = jmx._decode_dense2_device(
        jnp.asarray(pj.code[cut:]), jnp.asarray(pj.scal[cut:]), ring_j,
        n_sub=pj.n_sub - cut, interpret=True)
    rows1, ring1 = tmx.route_jump_plain(
        torch.from_numpy(pt.code[:cut]), torch.from_numpy(pt.scal[:cut]),
        _segs(pt, 0, cut))
    assert torch.equal(ring1, ring_from_jax(ring_j))
    rows2, ring2 = tmx.route_jump_plain(
        torch.from_numpy(pt.code[cut:]), torch.from_numpy(pt.scal[cut:]),
        _segs(pt, cut, pt.n_sub, True), ring1)
    assert torch.equal(ring2, ring_from_jax(ring2_j))
    assert np.array_equal(rows1.numpy(), np.asarray(rows1_j).reshape(-1))
    assert np.array_equal(rows2.numpy(), np.asarray(rows2_j).reshape(-1))
    whole = np.concatenate([rows1.numpy(), rows2.numpy()])
    assert whole[:len(blob)].tobytes() == blob


@pytest.mark.parametrize("make", [_single, _multi], ids=["one", "chains"])
def test_pointer_jumping_part_subs(make):
    blob, pt, pj = make()
    rows, ring = _jump_rows(pt, part_subs=5)
    rows_s, ring_s = tmx.decode_dense2_rows(pt, "cpu", part_subs=5)
    assert torch.equal(rows, rows_s) and torch.equal(ring, ring_s)
    ref = jmx.decode_dense2_rows(pj, interpret=True, part_subs=5)
    assert np.array_equal(rows.numpy(), ref)
    assert _spans_bytes(rows.numpy(), pt) == blob


def test_pointer_jumping_seeded_ring():
    """A seeded ring reaches the first chain as K4's ring_in does, and
    ring_out's blocks below the last 32 substeps come from it."""
    _blob, pt, pj = _single()
    seed = np.random.default_rng(9).integers(0, 256, 65536, dtype=np.uint8)
    ring_j = jnp.asarray(seed.reshape(256, 256).astype(np.float32),
                         jnp.bfloat16)
    ref = jmx.decode_dense2_rows(pj, interpret=True, ring_init=ring_j)
    rows, _ = _jump_rows(pt, ring_in=torch.from_numpy(seed))
    assert np.array_equal(rows.numpy(), ref)
    short = 10          # fewer substeps than the ring holds
    code = torch.from_numpy(pt.code[:short])
    scal = torch.from_numpy(pt.scal[:short])
    segs = segments_tensor([(0, short, 1)], "cpu")
    got = tmx.route_jump_plain(code, scal, segs, torch.from_numpy(seed))
    want = tmx.route_plain(code, scal, segs, torch.from_numpy(seed))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert np.array_equal(got[1].numpy()[short * tmx.SUB:],
                          seed[short * tmx.SUB:])


def test_pointer_jumping_words_corpus():
    """4 MiB of word tokens: one dense chain of 2048 substeps whose
    reference chains run hundreds of links deep."""
    blob = _words(4 << 20)
    pt, pj = _packs(lz4tpu.compress(blob))
    assert pt.n_sub == 2048 and len(pt.out_spans) == 1
    code, scal = torch.from_numpy(pt.code), torch.from_numpy(pt.scal)
    state = tmx.sources_plain(code, scal, _segs(pt))
    used = next(k for k in range(1, 20)
                if not bool((tmx.jump_plain(state, k) >= 0).any()))
    assert 6 <= used <= tmx.passes_for(pt.n_sub)
    rows, ring = tmx.route_jump_plain(code, scal, _segs(pt))
    rows_s, ring_s = tmx.route_plain(code, scal, _segs(pt))
    assert torch.equal(rows, rows_s) and torch.equal(ring, ring_s)
    assert rows.numpy()[:len(blob)].tobytes() == blob
    ref = jmx.decode_dense2_rows(pj, interpret=True)
    assert np.array_equal(rows.numpy(), ref)


@pytest.mark.parametrize("n_sub", [1, 2, 33, 257])
def test_pointer_jumping_deepest_chain(n_sub):
    """A chain n_sub - 1 links deep resolves within passes_for(n_sub)
    passes, and not in fewer than doubling needs."""
    code, scal = (torch.from_numpy(a) for a in edge.deep_chain(n_sub))
    segs = segments_tensor([(0, n_sub, 0)], "cpu")
    state = tmx.sources_plain(code, scal, segs)
    # after k passes a word holds the one 2**k - 1 links on: n_sub - 1
    # links need 2**k >= n_sub
    need = (n_sub - 1).bit_length()
    if need:
        assert bool((tmx.jump_plain(state, need - 1) >= 0).any())
    assert not bool((tmx.jump_plain(state, need) >= 0).any())
    assert need <= tmx.passes_for(n_sub)
    got = tmx.route_jump_plain(code, scal, segs)
    want = tmx.route_plain(code, scal, segs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ring_rows_must_advance_by_eight():
    _blob, pt, _pj = _multi()
    tmx.check_ring_rows(pt.scal, pt.out_spans)
    for bad in ((3, 16), (1, 4)):          # a skipped row, a row off 8
        scal = pt.scal.copy()
        scal[bad[0], 0] = bad[1]
        pack = tmx.DensePack2(code=pt.code, scal=scal, n_sub=pt.n_sub,
                              out_spans=pt.out_spans)
        with pytest.raises(ValueError, match="advance 8"):
            tmx.decode_dense2_rows(pack, "cpu")
