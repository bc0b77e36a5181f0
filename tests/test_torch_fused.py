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
from lz4tpu_torch.exp import edge


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


# ---------------------------------------------------------------------------
# the route at the edges of its gather: words, runs, ring end, ring carry
# ---------------------------------------------------------------------------

def _gather_edges(pos: np.ndarray) -> dict:
    """How many threads (four consecutive bytes each) hold each edge."""
    p = pos.reshape(-1, 4).astype(np.int64)
    consecutive = (np.diff(p, axis=1) == 1).all(1)
    in_win = p >= 65536
    return {
        # one run, not word-aligned: its bytes lie in two 32-bit words
        "straddles_word": int((consecutive & (p[:, 0] % 4 != 0)).sum()),
        "run_ends_inside": int((~consecutive).sum()),
        # ring sources and window sources in one thread
        "ring_and_window": int((in_win.any(1) & ~in_win.all(1)).sum()),
        # consecutive in pos17 over the ring's end: 65535 then 65536
        "over_ring_end": int(((p[:, :-1] == 65535)
                              & (p[:, 1:] == 65536)).any(1).sum()),
    }


def _route_args(case):
    pos, lits, winq, scal = case
    return (torch.from_numpy(pos), torch.from_numpy(lits),
            torch.from_numpy(winq), torch.from_numpy(scal))


def _jax_route(case, ring_in=None, lo=0, hi=None):
    """The JAX package's routing kernel alone (``_make_route_kernel``
    under the second ``pallas_call`` of ``_decode_split_device``), in
    interpret mode, on substeps ``[lo, hi)`` of a route case as one
    chain: ``(rows, ring)`` as flat uint8 numpy arrays."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    pos, lits, winq, scal = case
    hi = pos.shape[0] if hi is None else hi
    n = hi - lo
    scal8 = np.zeros((-(-n // 8) * 8, 8), np.int32)
    scal8[:n] = scal[lo:hi]
    ring = np.zeros(65536, np.uint8) if ring_in is None else ring_in
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(n,),
        in_specs=[
            pl.BlockSpec((jfu.NCHUNK, jfu.CHUNK), lambda i, wq: (i, 0)),
            pl.BlockSpec((1, 32, 256), lambda i, wq: (wq[i], 0, 0)),
            pl.BlockSpec((8, 8), lambda i, wq: (i // 8, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((jfu.RPAGES, jfu.ROWB), lambda i, wq: (0, 0)),
        ],
        out_specs=(
            pl.BlockSpec((jfu.SUB // 128, 128), lambda i, wq: (i, 0)),
            pl.BlockSpec((jfu.RPAGES, jfu.ROWB), lambda i, wq: (0, 0)),
        ),
        scratch_shapes=[pltpu.VMEM((jfu.KPAGES, jfu.ROWB), jnp.bfloat16)],
    )
    rows, ring_out = pl.pallas_call(
        jfu._make_route_kernel(),
        grid_spec=grid_spec,
        out_shape=(
            jax.ShapeDtypeStruct((n * jfu.SUB // 128, 128), jnp.bfloat16),
            jax.ShapeDtypeStruct((jfu.RPAGES, jfu.ROWB), jnp.bfloat16),
        ),
        interpret=True,
    )(jnp.asarray(winq[lo:hi]),
      jnp.asarray(pos[lo:hi].reshape(n * jfu.NCHUNK, jfu.CHUNK)),
      jnp.asarray(lits), jnp.asarray(scal8),
      jnp.asarray(ring.reshape(jfu.RPAGES, jfu.ROWB).astype(np.float32),
                  jnp.bfloat16))

    def to_u8(x):
        return np.asarray(jax.device_get(x), np.float32).astype(
            np.uint8).reshape(-1)

    return to_u8(rows), to_u8(ring_out)


@pytest.mark.parametrize("seeded", [False, True], ids=["zero_ring", "seeded"])
def test_route_plain_on_edge_sources_matches_reference(seeded):
    """Sources that straddle a 4-byte word, end a run inside a thread,
    mix ring and window, or run over the ring's end into the window:
    the plain route, the numpy reference and the JAX package's routing
    kernel give the same rows and the same ring."""
    case = edge.route_case()
    n = case[0].shape[0]
    assert all(v > 20 for v in _gather_edges(case[0]).values())
    assert case[0].max() == 65536 + 4095 and case[0].min() == 0
    ring_in = (np.random.default_rng(9).integers(0, 256, 65536,
                                                 dtype=np.uint8)
               if seeded else None)
    segs = [(0, n, int(seeded))]
    rows, ring = tfu.route(
        *_route_args(case), segments_tensor(segs, "cpu"),
        torch.from_numpy(ring_in) if seeded else None)
    want_rows, want_ring = edge.ref_route(*case, segs, ring_in)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(ring.numpy(), want_ring)
    rows_j, ring_j = _jax_route(case, ring_in)
    assert np.array_equal(rows.numpy(), rows_j)
    assert np.array_equal(ring.numpy(), ring_j)


@pytest.mark.parametrize("cut", [1, 17, 39])
def test_route_ring_carried_across_two_segments(cut):
    """Substeps [0, cut) and [cut, n) as two launches, the first one's
    ring seeding the second, equal one launch over [0, n); and one
    launch of two segments decodes each from its own start (the second
    from zeros, or from ``ring_in`` when it carries)."""
    case = edge.route_case()
    args = _route_args(case)
    n = case[0].shape[0]
    whole, ring_whole = tfu.route(*args, segments_tensor([(0, n, 0)], "cpu"))

    def part(lo, hi, ring):
        pos, lits, winq, scal = args
        return tfu.route(pos[lo:hi], lits, winq[lo:hi], scal[lo:hi],
                         segments_tensor([(0, hi - lo, int(ring is not None))],
                                         "cpu"), ring)

    rows1, ring1 = part(0, cut, None)
    rows2, ring2 = part(cut, n, ring1)
    assert torch.equal(torch.cat([rows1, rows2]), whole)
    assert torch.equal(ring2, ring_whole)
    # the JAX package's routing kernel, its ring carried the same way
    rows1_j, ring1_j = _jax_route(case, None, 0, cut)
    rows2_j, ring2_j = _jax_route(case, ring1_j, cut, n)
    assert np.array_equal(rows1.numpy(), rows1_j)
    assert np.array_equal(ring1.numpy(), ring1_j)
    assert np.array_equal(rows2.numpy(), rows2_j)
    assert np.array_equal(ring2.numpy(), ring2_j)
    ring_in = np.random.default_rng(cut).integers(0, 256, 65536,
                                                  dtype=np.uint8)
    for carry in (0, 1):
        segs = [(0, cut, 0), (cut, n, carry)]
        rows, ring = tfu.route(*args, segments_tensor(segs, "cpu"),
                               torch.from_numpy(ring_in))
        want_rows, want_ring = edge.ref_route(*case, segs, ring_in)
        assert np.array_equal(rows.numpy(), want_rows)
        assert np.array_equal(ring.numpy(), want_ring)


def test_route_clamps_sources_outside_the_17_bit_space():
    """No prep makes a source below 0 or past the window's end.  The
    plain route reads such a source as ``golden_decode`` does, clamped
    to ring byte 0 or to the window's last byte; the JAX package's
    routing kernel, whose one-hot page match finds no page for it, reads
    0 there.  Shown on the first substep, before the difference spreads
    through the ring."""
    case = edge.route_case(n_sub=8, stray=True)
    pos, lits, winq, scal = case
    ring_in = np.random.default_rng(9).integers(1, 256, 65536,
                                                 dtype=np.uint8)
    segs = [(0, 8, 1)]
    rows, ring = tfu.route(*_route_args(case), segments_tensor(segs, "cpu"),
                           torch.from_numpy(ring_in))
    want_rows, want_ring = edge.ref_route(*case, segs, ring_in)
    assert np.array_equal(rows.numpy(), want_rows)
    assert np.array_equal(ring.numpy(), want_ring)
    first = pos[0].astype(np.int64)
    below, above = first < 0, first >= 65536 + 4096
    assert below.sum() == 8 and above.sum() == 8
    got = rows.numpy()[:tfu.SUB]
    win = lits.reshape(lits.shape[0], -1)[winq[0]][
        scal[0, 1] * 256: scal[0, 1] * 256 + 4096]
    assert (got[below] == ring_in[0]).all() and (got[above] == win[-1]).all()
    rows_j, _ring_j = _jax_route(case, ring_in)
    inside = ~(below | above)
    assert np.array_equal(rows_j[:tfu.SUB][inside], got[inside])
    assert not rows_j[:tfu.SUB][below | above].any()


def test_real_prep_holds_the_gather_edges_and_matches_golden():
    """A real fused prep has threads whose sources straddle a word, end
    a run and mix ring with window; its routed bytes equal
    ``golden_decode``'s."""
    _blob, prep_t, prep_j = _single(64 << 10)
    n = prep_t.n_sub
    pos = tfu.expand(torch.from_numpy(prep_t.seqrec[:n]),
                     torch.from_numpy(prep_t.scal[:n]),
                     torch.from_numpy(prep_t.patch[:n]))
    found = _gather_edges(pos.numpy())
    for k in ("straddles_word", "run_ends_inside", "ring_and_window"):
        assert found[k] > 100, (k, found)
    flat, _ring = _rows(prep_t)
    assert np.array_equal(flat, jfu.golden_decode(prep_j))
