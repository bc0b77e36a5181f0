"""lz4tpu_torch.spans held against lz4tpu.spans on the CPU.

The same seeded inputs go through both packages: span plans, span
columns, boundary-ring resolution (native and numpy walks), the ring
seed's layout, span and slice preps, and span decodes (the port's plain
route against the JAX kernel in interpret mode and the original bytes).
Tolerance 0 throughout: the outputs are bytes and integers.
"""

import jax
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.pipeline as jpl
from lz4tpu import FOR_ALL
from lz4tpu import spans as jsp
from lz4tpu.device import fused as jfu

import lz4tpu_torch
from lz4tpu_torch import spans as tsp
from lz4tpu_torch.device import fused as tfu
from lz4tpu_torch.device.ring import part_segments, ring_from_jax


def _frag_text(n: int, seed: int) -> bytes:
    """chip_smoke.frag_text's recipe: n bytes of 8192 printable
    fragments of 3-8 bytes (one fused chain when compressed)."""
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    mean = np.mean([len(f) for f in frags])
    picks = rng.integers(0, 8192, int(n / mean * 1.1) + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _src_text(n: int) -> bytes:
    import lz4tpu.dist
    import lz4tpu_torch.pipeline

    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (jfu, jpl, lz4tpu.api, lz4tpu.dist, tsp,
                              lz4tpu_torch.pipeline))
    assert len(blob) >= n
    return blob[:n]


def _rle(n: int, seed: int) -> bytes:
    """Runs of one byte and short repeated patterns (deep overlapping
    matches, small offsets)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        pat = rng.integers(0, 256, int(rng.integers(1, 5)),
                           dtype=np.uint8).tobytes()
        out += pat * int(rng.integers(50, 3000))
        out += rng.integers(0, 256, int(rng.integers(1, 40)),
                            dtype=np.uint8).tobytes()
    return bytes(out[:n])


CORPORA = {
    "frag": lambda: _frag_text(300_000, 11),
    "src": lambda: _src_text(200_000),
    "rle": lambda: _rle(250_000, 3),
}


def _chain_cols(data):
    buf = np.frombuffer(data, np.uint8)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    table = jpl.build_seq_table(buf, parsed, FOR_ALL, data)
    chain = jpl._chains_of(table)[0]
    sl = slice(chain.seq_lo, chain.seq_hi)
    return (buf, table, chain,
            (np.array(table.lit_len[sl]), np.array(table.match_len[sl]),
             np.array(table.match_off[sl]), np.array(table.lit_src[sl])))


def _fused_fields(prep):
    return {k: np.asarray(getattr(prep, k)) for k in
            ("seqrec", "lits", "winq", "scal", "patch")}


def _assert_preps_equal(a, b):
    fa, fb = _fused_fields(a), _fused_fields(b)
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k
    for k in ("n_sub", "n_patches", "n_seq_recs", "out_spans", "max_off",
              "max_recs", "max_patches"):
        assert getattr(a, k) == getattr(b, k), k


def test_constants_match():
    assert (tsp.SUB, tsp.RING, tsp.RING_SUBS, tsp._RESOLVE_WORK_MAX) == (
        jsp.SUB, jsp.RING, jsp.RING_SUBS, jsp._RESOLVE_WORK_MAX)


PLAN_CASES = [(0, 4, 64), (1, 4, 64), (2048, 8, 64), (262_144, 2, 64),
              (262_144, 8, 64), (300_000, 3, 64), (1_137_664, 4, 64),
              (1_137_664, 8, 32), (33_554_432, 4, 64), (5_000_000, 7, 8),
              (700_000, 1, 64), (700_000, 16, 1), (131_073, 4, 64)]


@pytest.mark.parametrize("n_out,n_parts,min_subs", PLAN_CASES)
def test_plan_spans_matches_jax(n_out, n_parts, min_subs):
    got = tsp.plan_spans(n_out, n_parts, min_subs=min_subs)
    assert got == jsp.plan_spans(n_out, n_parts, min_subs=min_subs)
    if got:
        assert got[0][0] == 0 and got[-1][1] == -(-n_out // tsp.SUB)
        assert all(a % tsp.RING_SUBS == 0 for a, _b in got)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_split_chain_spans_columns_match_jax(name):
    blob = CORPORA[name]()
    buf, _table, chain, (ll, ml, mo, ls) = _chain_cols(lz4tpu.compress(blob))
    n_out = chain.out_hi - chain.out_lo
    starts = tsp._starts_ext(ll, ml)
    assert np.array_equal(starts, jsp._starts_ext(ll, ml))
    for parts, min_subs in ((2, 64), (3, 32), (5, 8)):
        ranges = tsp.plan_spans(n_out, parts, min_subs=min_subs)
        got = tsp.split_chain_spans(ll, ml, mo, ls, ranges, starts)
        want = jsp.split_chain_spans(ll, ml, mo, ls, ranges)
        assert len(got) == len(want) == len(ranges)
        for g, w in zip(got, want):
            assert (g.sub_lo, g.sub_hi, g.out_lo, g.out_hi) == (
                w.sub_lo, w.sub_hi, w.out_lo, w.out_hi)
            for k in ("ll", "ml", "mo", "ls"):
                assert getattr(g, k).dtype == np.int32
                assert np.array_equal(getattr(g, k), getattr(w, k)), k


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_resolve_ring_bytes_matches_jax_and_original(name):
    """Native and numpy walks of both packages give the bytes before
    each boundary (zeros before the chain start)."""
    blob = CORPORA[name]()
    buf, _table, chain, (ll, ml, mo, ls) = _chain_cols(lz4tpu.compress(blob))
    starts = tsp._starts_ext(ll, ml)
    n_out = chain.out_hi - chain.out_lo
    for B in (2048, tsp.RING, 3 * tsp.RING - 4096, 2 * tsp.RING + 7,
              n_out - 1, n_out):
        want = np.zeros(tsp.RING, np.uint8)
        lo = max(B - tsp.RING, 0)
        want[tsp.RING - (B - lo):] = np.frombuffer(blob[lo:B], np.uint8)
        for nbytes in (tsp.RING, 4096):
            outs = (
                tsp.resolve_ring_bytes(ll, ml, mo, ls, buf, B, nbytes,
                                       starts),
                tsp._resolve_ring_bytes_numpy(ll, ml, mo, ls, buf, B,
                                              nbytes, starts),
                jsp.resolve_ring_bytes(ll, ml, mo, ls, buf, B, nbytes,
                                       starts),
                jsp._resolve_ring_bytes_numpy(ll, ml, mo, ls, buf, B,
                                              nbytes, starts),
            )
            for o in outs:
                assert o.dtype == np.uint8
                assert np.array_equal(o, want[tsp.RING - nbytes:]), (B,
                                                                     nbytes)


def test_resolve_ring_bytes_zero_boundary():
    blob = _frag_text(100_000, 2)
    buf, _t, _c, (ll, ml, mo, ls) = _chain_cols(lz4tpu.compress(blob))
    for fn in (tsp.resolve_ring_bytes, tsp._resolve_ring_bytes_numpy):
        out = fn(ll, ml, mo, ls, buf, 0)
        assert out.shape == (tsp.RING,) and not out.any()


def test_resolve_overflow_on_a_tiny_work_budget():
    blob = _frag_text(200_000, 3)
    buf, _t, _c, (ll, ml, mo, ls) = _chain_cols(lz4tpu.compress(blob))
    B = 3 * tsp.RING
    for port, jax_fn in ((tsp.resolve_ring_bytes, jsp.resolve_ring_bytes),
                         (tsp._resolve_ring_bytes_numpy,
                          jsp._resolve_ring_bytes_numpy)):
        with pytest.raises(tsp.SpanResolveOverflow) as got:
            port(ll, ml, mo, ls, buf, B, work_max=100)
        with pytest.raises(jsp.SpanResolveOverflow) as want:
            jax_fn(ll, ml, mo, ls, buf, B, work_max=100)
        assert str(got.value) == str(want.value)
        assert type(got.value).__name__ == type(want.value).__name__


def test_resolve_rings_threaded_matches_serial(monkeypatch):
    blob = _frag_text(300_000, 7)
    buf, _t, _c, (ll, ml, mo, ls) = _chain_cols(lz4tpu.compress(blob))
    bounds = [tsp.RING, 2 * tsp.RING, 3 * tsp.RING, 4 * tsp.RING]
    serial = [tsp.resolve_ring_bytes(ll, ml, mo, ls, buf, b) for b in bounds]
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "3")
    threaded = tsp.resolve_rings(ll, ml, mo, ls, buf, bounds)
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "1")
    one = tsp.resolve_rings(ll, ml, mo, ls, buf, bounds)
    want = jsp.resolve_rings(ll, ml, mo, ls, buf, bounds)
    for a, b, c, d in zip(serial, threaded, one, want):
        assert np.array_equal(a, b) and np.array_equal(a, c)
        assert np.array_equal(a, d)


@pytest.mark.parametrize("boundary", [tsp.RING, 5 * tsp.RING, 3 * tsp.RING
                                      + 2048, 777])
def test_ring_seed_array_is_jaxs_layout(boundary):
    """The port's (RING,) seed equals the JAX package's (256, 256) bf16
    seed at full width, through ring_from_jax; at a 64 KiB multiple it
    is the window in order."""
    window = np.random.default_rng(boundary).integers(
        0, 256, tsp.RING + 100, dtype=np.uint8)
    got = tsp.ring_seed_array(window, boundary, "cpu")
    assert got.dtype == torch.uint8 and got.shape == (tsp.RING,)
    want = ring_from_jax(jsp.ring_seed_array(window, boundary, 256))
    assert torch.equal(got, want)
    if boundary % tsp.RING == 0:
        assert np.array_equal(got.numpy(), window[-tsp.RING:])


def _split(blob, parts, min_subs):
    buf, table, chain, cols = _chain_cols(lz4tpu.compress(blob))
    n_out = chain.out_hi - chain.out_lo
    ranges = tsp.plan_spans(n_out, parts, min_subs=min_subs)
    assert len(ranges) == parts
    return buf, table, chain, cols, ranges


def test_prep_span_matches_jax():
    buf, _t, _c, (ll, ml, mo, ls), ranges = _split(_frag_text(300_000, 4),
                                                   3, 32)
    for s_t, s_j in zip(tsp.split_chain_spans(ll, ml, mo, ls, ranges),
                        jsp.split_chain_spans(ll, ml, mo, ls, ranges)):
        _assert_preps_equal(tsp.prep_span(s_t, buf, pooled=False),
                            jsp.prep_span(s_j, buf, pooled=False))


def test_slice_prep_arrays_match_jax():
    buf, _t, _c, (ll, ml, mo, ls), ranges = _split(_frag_text(300_000, 5),
                                                   4, 16)
    tprep = tfu.prep_fused(ll, ml, mo, ls, buf, pooled=False)
    jprep = jfu.prep_fused(ll, ml, mo, ls, buf, pooled=False)
    n_out = int(tsp._starts_ext(ll, ml)[-1])
    for a, b in ranges:
        out_len = min(b * tsp.SUB, n_out) - a * tsp.SUB
        _assert_preps_equal(tsp.slice_prep(tprep, a, b, out_len),
                            jsp.slice_prep(jprep, a, b, out_len))


def test_slices_decode_mid_window_and_mid_sequence():
    """Chain-coordinate slices of one prep, each routed from its
    resolved ring: some slice begins inside a literal window (window
    offset > 0) and inside a sequence (nonzero carries), and every
    slice decodes to the original bytes."""
    blob = _frag_text(400_000, 6)
    buf, _t, _c, (ll, ml, mo, ls), ranges = _split(blob, 6, 8)
    prep = tfu.prep_fused(ll, ml, mo, ls, buf, pooled=False)
    starts = tsp._starts_ext(ll, ml)
    n_out = int(starts[-1])
    firsts = np.array([prep.scal[a] for a, _b in ranges[1:]])
    assert (firsts[:, 1] > 0).any()              # window offset
    assert (firsts[:, 3:6] != 0).any()           # carried u0/v0/b0
    bounds = [a * tsp.SUB for a, _b in ranges]
    assert not np.isin(bounds[1:], starts).all()  # a cut inside a sequence
    out = bytearray()
    for a, b in ranges:
        out_len = min(b * tsp.SUB, n_out) - a * tsp.SUB
        ring = (None if a == 0 else
                tsp.resolve_ring_bytes(ll, ml, mo, ls, buf, a * tsp.SUB))
        rows = tsp.decode_span_on_device(
            tsp.slice_prep(prep, a, b, out_len), ring, a * tsp.SUB,
            device="cpu")
        out += rows[:out_len].numpy().tobytes()
    assert bytes(out) == blob


def test_part_segments_seed_all_but_the_first_span():
    """A span with a ring is one seeded segment; span 0 starts from
    zeros (the route kernel's carry flag)."""
    blob = _frag_text(300_000, 8)
    buf, _t, _c, (ll, ml, mo, ls), ranges = _split(blob, 2, 32)
    spans = tsp.split_chain_spans(ll, ml, mo, ls, ranges)
    for k, s in enumerate(spans):
        prep = tsp.prep_span(s, buf, pooled=False)
        segs = part_segments(prep.out_spans, 0, prep.n_sub, seeded=k > 0)
        assert segs == [(0, prep.n_sub, int(k > 0))]


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_decode_span_on_device_matches_jax_kernel(parts):
    """Span-local preps decoded by the port's plain route and by the JAX
    package's fused kernel in interpret mode, each from its boundary
    ring: the same rows, and the original bytes."""
    blob = _frag_text(parts * 70_000, 20 + parts)
    buf, _t, _c, (ll, ml, mo, ls), ranges = _split(blob, parts, 16)
    starts = tsp._starts_ext(ll, ml)
    out = bytearray()
    for s in tsp.split_chain_spans(ll, ml, mo, ls, ranges, starts):
        prep_t = tsp.prep_span(s, buf, pooled=False)
        prep_j = jsp.prep_span(s, buf, pooled=False)
        ring = (None if s.out_lo == 0 else
                tsp.resolve_ring_bytes(ll, ml, mo, ls, buf, s.out_lo,
                                       tsp.RING, starts))
        got = tsp.decode_span_on_device(prep_t, ring, s.out_lo, device="cpu")
        want = np.asarray(jax.device_get(jsp.decode_span_on_device(
            prep_j, ring, s.out_lo, interpret=True))).reshape(-1)
        n = s.out_hi - s.out_lo
        assert got.dtype == torch.uint8 and got.shape == (prep_t.n_sub
                                                          * tsp.SUB,)
        assert np.array_equal(got.numpy()[:n], want[:n])
        out += got.numpy()[:n].tobytes()
    assert bytes(out) == blob


def test_split_fused_chain_matches_jax():
    blob = _frag_text(400_000, 9)
    data = lz4tpu.compress(blob)
    buf, table, chain, _cols = _chain_cols(data)
    got = tsp.split_fused_chain(table, chain, buf, 4)
    want = jsp.split_fused_chain(table, chain, buf, 4)
    assert got is not None and want is not None
    (spans_t, preps_t, rings_t), (spans_j, preps_j, rings_j) = got, want
    assert len(spans_t) == len(spans_j) > 1
    assert rings_t[0] is None and rings_j[0] is None
    for s_t, s_j, p_t, p_j, r_t, r_j in zip(spans_t, spans_j, preps_t,
                                             preps_j, rings_t, rings_j):
        assert (s_t.out_lo, s_t.out_hi) == (s_j.out_lo, s_j.out_hi)
        _assert_preps_equal(p_t, p_j)
        if r_t is not None:
            assert np.array_equal(r_t, r_j)
    out = bytearray()
    for s, p, r in zip(spans_t, preps_t, rings_t):
        out += tsp.decode_span_on_device(p, r, s.out_lo, "cpu")[
            : s.out_hi - s.out_lo].numpy().tobytes()
    assert bytes(out) == blob
    no_rings = tsp.split_fused_chain(table, chain, buf, 4, with_rings=False)
    assert no_rings[2] is None and len(no_rings[0]) == len(spans_t)
    small = _chain_cols(lz4tpu.compress(blob[:100_000]))
    assert tsp.split_fused_chain(small[1], small[2], small[0], 4) is None
    assert jsp.split_fused_chain(small[1], small[2], small[0], 4) is None


def test_decode_span_on_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    blob = _frag_text(10_000, 1)
    buf, _t, _c, (ll, ml, mo, ls) = _chain_cols(lz4tpu_torch.compress(blob))
    prep = tfu.prep_fused(ll, ml, mo, ls, buf, pooled=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsp.decode_span_on_device(prep, None, 0)
