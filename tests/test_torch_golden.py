"""lz4tpu_torch's numpy model of kernel H1, ``fused.golden_decode``, and
the helpers of its numpy prep, held against lz4tpu's on the CPU.

``golden_decode`` is the spec of the prep's arrays: it must equal
``lz4tpu.device.fused.golden_decode`` on the same prep, with and
without a seeded ring, give the original bytes, and equal the port's
plain decode (``decode_split``, ``decode_fused_rows`` on the CPU).  The
prep's helpers (``_first_seq``, ``_digits256``, ``_resolve_patches``,
``_group_scatter``, ``_decode_records``) must return what lz4tpu's
return on seeded inputs.  Tolerance 0 throughout.
"""

import numpy as np
import pytest
import torch

import lz4tpu
from lz4tpu.device import fused as jfu
from lz4tpu_torch import pipeline as tpl
from lz4tpu_torch.device import fused as tfu


def _frag_text(n: int, seed: int) -> bytes:
    """n bytes of 8192 printable fragments of 3-8 bytes (fused)."""
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    mean = np.mean([len(f) for f in frags])
    picks = rng.integers(0, 8192, int(n / mean * 1.1) + 16)
    return b"".join(frags[i] for i in picks)[:n]


FRAMES = {
    "frag": (120_000, 21, {}),
    "legacy": (90_000, 22, dict(frame_format="legacy")),
    "chains": (150_000, 23, dict(block_independence=True,
                                 block_max_code=4)),
}


def _prep(name: str, how: str):
    """(prep, original bytes, chain count) of a corpus, prepared by the
    port's native or numpy prep."""
    n, seed, kw = FRAMES[name]
    blob = _frag_text(n, seed)
    data = lz4tpu.compress(blob, **kw)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, tpl.FOR_ALL)
    t = tpl.build_seq_table(buf, parsed, tpl.FOR_ALL, data)
    ranges = [(c.seq_lo, c.seq_hi) for c in tpl._chains_of(t)]
    cols = (t.lit_len, t.match_len, t.match_off, t.lit_src, buf)
    if how == "native":
        prep = tfu._prep_fused_native(*cols, ranges, pooled=False)
    else:
        prep = tfu._prep_fused_numpy(*cols, ranges)
    return prep, blob, len(ranges)


def _chain_bytes(flat: np.ndarray, prep) -> bytes:
    return b"".join(flat[slo * tfu.SUB: slo * tfu.SUB + n].tobytes()
                    for (_c, slo, _shi, n) in prep.out_spans)


def _ring(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, tfu.RING,
                                                dtype=np.uint8)


@pytest.mark.parametrize("how", ["native", "numpy"])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_golden_decode_matches_jax_and_original(name, how):
    prep, blob, _n = _prep(name, how)
    got = tfu.golden_decode(prep)
    assert got.dtype == np.uint8 and got.shape == (prep.n_sub * tfu.SUB,)
    assert np.array_equal(got, jfu.golden_decode(prep))
    assert _chain_bytes(got, prep) == blob


@pytest.mark.parametrize("how", ["native", "numpy"])
def test_golden_decode_seeded_ring_matches_jax(monkeypatch, how):
    """The second span of a split chain reaches back before its start:
    with the boundary's ring (span decode's history) both models give
    the span's bytes, without it other bytes."""
    from lz4tpu_torch import native
    from lz4tpu_torch import spans as tsp

    blob = _frag_text(300_000, 24)
    data = lz4tpu.compress(blob)
    buf = np.frombuffer(data, np.uint8)
    t = tpl.build_seq_table(buf, tpl.parse_frames(buf, tpl.FOR_ALL),
                            tpl.FOR_ALL, data)
    cols = (t.lit_len, t.match_len, t.match_off, t.lit_src)
    spans = tsp.split_chain_spans(*cols, tsp.plan_spans(len(blob), 2))
    assert len(spans) == 2
    sp = spans[1]
    if how == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    prep = tsp.prep_span(sp, buf, pooled=False)
    ring = tsp.resolve_ring_bytes(*cols, buf, sp.out_lo)
    assert sp.out_lo % tfu.RING == 0      # ring layout = the window
    got = tfu.golden_decode(prep, ring_init=ring)
    assert np.array_equal(got, jfu.golden_decode(prep, ring_init=ring))
    assert got[:sp.out_hi - sp.out_lo].tobytes() == blob[sp.out_lo:sp.out_hi]
    assert not np.array_equal(got, tfu.golden_decode(prep))


@pytest.mark.parametrize("seeded", [False, True], ids=["zero_ring", "seeded"])
@pytest.mark.parametrize("how", ["native", "numpy"])
def test_golden_decode_matches_plain_decode_split(how, seeded):
    """The port's plain decode of kernel H1 (``decode_split`` on CPU
    tensors) against the golden model, ring seed included."""
    prep, _blob, _n = _prep("frag", how)
    ring = _ring(9) if seeded else None
    n = prep.n_sub
    rows, _ring_out = tfu.decode_split(
        torch.from_numpy(np.ascontiguousarray(prep.seqrec[:n])),
        torch.from_numpy(np.ascontiguousarray(prep.lits)),
        torch.from_numpy(np.ascontiguousarray(prep.winq[:n])),
        torch.from_numpy(np.ascontiguousarray(prep.scal[:n])),
        torch.from_numpy(np.ascontiguousarray(prep.patch[:n])),
        None if ring is None else torch.from_numpy(ring), n_sub=n)
    assert np.array_equal(rows.numpy(), tfu.golden_decode(prep, ring))


@pytest.mark.parametrize("how", ["native", "numpy"])
def test_golden_decode_matches_plain_rows_multi_chain(how):
    """Several chains: each starts from a zero ring in both."""
    prep, blob, n_chains = _prep("chains", how)
    assert n_chains == 3
    rows, _ring_out = tfu.decode_fused_rows(prep, "cpu")
    golden = tfu.golden_decode(prep)
    assert np.array_equal(rows.numpy(), golden)
    assert tfu.decode_fused(prep, device="cpu") == [
        (c, golden[slo * tfu.SUB: slo * tfu.SUB + n].tobytes())
        for (c, slo, _shi, n) in prep.out_spans]
    assert _chain_bytes(golden, prep) == blob


def test_golden_decode_ring_init_single_chain_only():
    prep, _blob, _n = _prep("chains", "numpy")
    with pytest.raises(ValueError, match="single-chain only"):
        tfu.golden_decode(prep, ring_init=_ring(1))


def test_golden_decode_empty_prep():
    prep = tfu._prep_fused_numpy(*(np.zeros(0, np.int32),) * 4,
                                 np.zeros(0, np.uint8))
    assert prep.n_sub == 0
    assert tfu.golden_decode(prep).size == 0
    assert jfu.golden_decode(prep).size == 0


# ---------------------------------------------------------------------------
# the prep's helpers
# ---------------------------------------------------------------------------

def test_first_seq_matches_jax():
    rng = np.random.default_rng(3)
    starts = np.concatenate([[0], np.cumsum(rng.integers(0, 9, 500))])
    pos = rng.integers(-5, int(starts[-1]) + 5, 2000)
    got = tfu._first_seq(starts, pos)
    assert got.dtype == np.int64
    assert np.array_equal(got, jfu._first_seq(starts, pos))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_digits256_matches_jax(n):
    x = np.random.default_rng(4).integers(-(1 << 20), 1 << 20, 3000)
    got, carry = tfu._digits256(x, n)
    want, wcarry = jfu._digits256(x, n)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(carry, wcarry)
    assert all(d.min() >= -128 and d.max() <= 127 for d in got)
    total = carry * (256 ** n) + sum(d * 256 ** k for k, d in enumerate(got))
    assert np.array_equal(total, x)


def test_decode_records_matches_jax():
    rng = np.random.default_rng(6)
    r0 = rng.integers(0, 1 << 31, 4000, dtype=np.int64)
    r1 = rng.integers(0, 1 << 32, 4000, dtype=np.int64)
    for a, b in zip(tfu._decode_records(r0, r1),
                    jfu._decode_records(r0, r1)):
        assert np.array_equal(a, b)


def test_group_scatter_matches_jax():
    rng = np.random.default_rng(7)
    sub_i = rng.integers(0, 40, 900)
    recs = [rng.integers(1, 1 << 30, 900), rng.integers(1, 1 << 30, 900)]
    got = tfu._group_scatter(sub_i, recs, 40, 64, "records")
    want = jfu._group_scatter(sub_i, recs, 40, 64, "records")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(tfu.FusedOverflow) as et:
        tfu._group_scatter(sub_i, recs, 40, 8, "records")
    with pytest.raises(jfu.FusedOverflow) as ej:
        jfu._group_scatter(sub_i, recs, 40, 8, "records")
    assert str(et.value) == str(ej.value)


def _patch_columns(seed: int):
    """A chain of short matches at small offsets (in-substep links)."""
    rng = np.random.default_rng(seed)
    s = 3000
    ll = rng.integers(0, 4, s)
    ml = rng.integers(4, 12, s)
    mo = rng.integers(1, 40, s)
    ll[0] = max(int(ll[0]), 1)              # the chain opens on a literal
    sizes = ll + ml
    starts = np.concatenate([[0], np.cumsum(sizes)])
    litpos = np.concatenate([[0], np.cumsum(ll)])
    n_out = int(starts[-1])
    pst = np.concatenate([starts[:-1], [n_out], [tfu.SENTINEL]])
    pll = np.concatenate([ll, [0, 0]])
    pmo = np.concatenate([mo, [1, 1]])
    pli = np.concatenate([litpos[:-1], [litpos[-1], litpos[-1]]])
    m0 = starts[:-1] + ll
    pos = np.concatenate([np.arange(a, b) for a, b in zip(m0, starts[1:])])
    return pst, pll, pmo, pli, pos, (pos // tfu.SUB) * tfu.SUB


@pytest.mark.parametrize("seed", [1, 2])
def test_resolve_patches_matches_jax(seed):
    pst, pll, pmo, pli, pos, sub_base = _patch_columns(seed)
    got = tfu._resolve_patches(pst, pll, pmo, pli, pos, sub_base)
    assert np.array_equal(
        got, jfu._resolve_patches(pst, pll, pmo, pli, pos, sub_base))
    # every code is a ring position or a literal of the stream
    assert ((got >= 0) | (-got - 1 < pli[-1])).all()


def test_resolve_patches_depth_overflow_matches_jax():
    """A run of offset-1 matches 100 bytes long: the last byte's chain
    is 99 links deep within its substep."""
    pst = np.array([0, 1, 101, tfu.SENTINEL])
    pll = np.array([1, 0, 0, 0])
    pmo = np.array([1, 1, 1, 1])
    pli = np.array([0, 1, 1, 1])
    pos = np.arange(1, 101)
    base = np.zeros(pos.size, np.int64)
    with pytest.raises(tfu.FusedOverflow) as et:
        tfu._resolve_patches(pst, pll, pmo, pli, pos, base)
    with pytest.raises(jfu.FusedOverflow) as ej:
        jfu._resolve_patches(pst, pll, pmo, pli, pos, base)
    assert str(et.value) == str(ej.value) == "patch chain deeper than 64"
