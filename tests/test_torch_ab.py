"""The port's A/B harness pieces (lz4tpu_torch.exp.ab) on the CPU: its
numpy packer against lz4tpu's mxu2 packer, the plain versions of kernel
H7 (the serial spec and the pointer-jumping decode, with its sources
state against a brute-force walk of the ring) against the original
bytes for every substep size (ring wrapped at least twice), against
each other on made-up codes that read a seeded ring, and against the
TPU harness kernel K9 itself (``exp/ab.py`` loaded by path, its
``pl.pallas_call`` run in interpret mode).  Tolerance 0.
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.native as jnative
import lz4tpu.pipeline as jpl
import lz4tpu.stream as jstream
from lz4tpu import FOR_ALL
from lz4tpu.device import fused as jfu
from lz4tpu.device import encode as jenc
from lz4tpu.device import mxu2 as jmx
from lz4tpu_torch.device.ring import RING, ring_from_jax, ring_to_jax
from lz4tpu_torch.exp import ab, edge

REPO = pathlib.Path(__file__).resolve().parent.parent


def _src_text(n: int) -> bytes:
    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (jfu, jpl, lz4tpu.api, jmx, jstream, jnative,
                              jenc))
    assert len(blob) >= n
    return blob[:n]


@functools.lru_cache(maxsize=None)
def _frame(n: int) -> tuple:
    blob = _src_text(n)
    return lz4tpu.compress(blob), blob


@functools.lru_cache(maxsize=None)
def _k9():
    """exp/ab.py as a module, its pallas_call in interpret mode (the
    file itself is untouched)."""
    spec = importlib.util.spec_from_file_location(
        "_exp_ab_k9", REPO / "exp" / "ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = mod.pl

    class PallasInterpret:
        pallas_call = staticmethod(
            functools.partial(real.pallas_call, interpret=True))

        def __getattr__(self, name):
            return getattr(real, name)

    mod.pl = PallasInterpret()
    return mod


def test_pack_host_2048_equals_pack_dense2():
    data, blob = _frame(200_000)
    code, scal, n_out = ab.pack_host(data, 2048)
    assert n_out == len(blob)
    buf = np.frombuffer(data, np.uint8)
    t = jpl.build_seq_table(buf, lz4tpu.frame.parse_frames(buf, FOR_ALL),
                            FOR_ALL, data)
    pack = jmx.pack_dense2(t.lit_len, t.match_len, t.match_off, t.lit_src,
                           buf)
    assert code.dtype == np.int32 and code.shape == pack.code.shape
    assert np.array_equal(code.reshape(-1)[:n_out],
                          pack.code.reshape(-1)[:n_out])
    assert np.array_equal(scal, pack.scal)


@pytest.mark.parametrize("sub", ab.SUBS)
def test_pack_host_shapes_and_codes(sub):
    data, blob = _frame(150_000)
    code, scal, n_out = ab.pack_host(data, sub)
    n_sub = -(-len(blob) // sub)
    assert code.shape == (n_sub, sub) and scal.shape == (n_sub, 1)
    assert n_out == len(blob)
    flat = code.reshape(-1)
    assert not flat[n_out:].any()
    is_ring = (flat[:n_out] >> 16) & 1 == 1
    # the first substep has nothing before it; a known byte is the byte
    assert not is_ring[:sub].any() and is_ring.any()
    assert not (flat[:n_out][is_ring] >> 17).any()
    want = np.frombuffer(blob, np.uint8)
    assert np.array_equal((flat[:n_out] >> 17)[~is_ring] & 255,
                          want[~is_ring])
    assert np.array_equal(scal[:, 0],
                          (np.arange(n_sub) * (sub // 256)) % 256)


@pytest.mark.parametrize("seeded", [False, True], ids=["zero-ring", "ring-in"])
@pytest.mark.parametrize("sub", ab.SUBS)
def test_plain_variant_decodes_and_wraps(sub, seeded):
    data, blob = _frame(210_000)             # wraps the ring three times
    assert len(blob) > 2 * RING + sub
    code, _scal, n_out = ab.pack_host(data, sub)
    ring_in = None
    if seeded:
        ring_in = torch.from_numpy(np.random.default_rng(sub).integers(
            0, 256, RING, dtype=np.uint8))
    rows, ring = ab.route_variant(torch.from_numpy(code), sub, ring_in)
    assert rows.dtype == torch.uint8 and rows.shape == (code.size,)
    assert rows.numpy()[:n_out].tobytes() == blob
    rows_j, ring_j = ab.route_variant_jump_plain(torch.from_numpy(code), sub,
                                                 ring_in)
    assert torch.equal(rows_j, rows) and torch.equal(ring_j, ring)
    # the ring holds the padded output's last 64 KiB at position mod 64 Ki
    flat = rows.numpy()
    pos = np.arange(flat.size - RING, flat.size)
    want_ring = np.empty(RING, np.uint8)
    want_ring[pos & (RING - 1)] = flat[pos]
    assert np.array_equal(ring.numpy(), want_ring)
    if seeded:
        assert torch.equal(ring_in, torch.from_numpy(
            np.random.default_rng(sub).integers(0, 256, RING,
                                                dtype=np.uint8)))


def test_plain_variant_reads_a_seeded_ring():
    """Ring codes in the first substep read ``ring_in``."""
    sub = 3072
    rng = np.random.default_rng(7)
    ring_in = torch.from_numpy(rng.integers(0, 256, RING, dtype=np.uint8))
    src = rng.integers(0, RING, (2, sub))
    code = torch.from_numpy((src | (1 << 16)).astype(np.int32))
    rows, ring = ab.route_variant_plain(code, sub, ring_in)
    first = ring_in.numpy()[src[0]]
    assert np.array_equal(rows.numpy()[:sub], first)
    after = ring_in.numpy().copy()
    after[:sub] = first
    assert np.array_equal(rows.numpy()[sub:], after[src[1]])
    none_rows, _ = ab.route_variant_plain(code, sub)
    assert not none_rows.any()


def test_sub_2048_equals_the_mxu2_plain_route():
    from lz4tpu_torch.device import mxu2 as tmx
    from lz4tpu_torch.device.ring import segments_tensor

    data, _blob = _frame(200_000)
    code, scal, _n = ab.pack_host(data, 2048)
    code_t, scal_t = torch.from_numpy(code), torch.from_numpy(scal)
    rows_a, ring_a = ab.route_variant_plain(code_t, 2048)
    rows_m, ring_m = tmx.route_plain(
        code_t, scal_t, segments_tensor([(0, code.shape[0], 0)], "cpu"))
    assert torch.equal(rows_a, rows_m) and torch.equal(ring_a, ring_m)


K9_CASES = {
    "base-2048-256-2": dict(variant="base", sub=2048, rowb=256, pack=2),
    "base-3072-256-3": dict(variant="base", sub=3072, rowb=256, pack=3),
    "base-2048-128-2": dict(variant="base", sub=2048, rowb=128, pack=2),
    "selfirst-4096-256-2": dict(variant="selfirst", sub=4096, rowb=256,
                                pack=2),
    "base-6144-256-2": dict(variant="base", sub=6144, rowb=256, pack=2),
    "selfirst-6144-256-3-ring": dict(variant="selfirst", sub=6144, rowb=256,
                                     pack=3, ring=True),
    "base-12288-256-2": dict(variant="base", sub=12288, rowb=256, pack=2),
    # made-up codes whose first substeps read the seeded ring
    "base-2048-128-2-madeup-ring": dict(variant="base", sub=2048, rowb=128,
                                        pack=2, ring=True, madeup=True),
    "base-3072-256-3-madeup-ring": dict(variant="base", sub=3072, rowb=256,
                                        pack=3, ring=True, madeup=True),
    "base-4096-256-2-madeup": dict(variant="base", sub=4096, rowb=256,
                                   pack=2, madeup=True),
    "base-12288-256-2-madeup-ring": dict(variant="base", sub=12288,
                                         rowb=256, pack=2, ring=True,
                                         madeup=True),
}


@pytest.mark.parametrize("case", sorted(K9_CASES))
def test_plain_variant_equals_k9(case):
    """K9 (exp/ab.py run_variant, interpret mode) and the port's plain
    versions (the serial spec and the pointer-jumping decode) on the same
    codes and initial ring: the same bytes and the same ring."""
    k9 = _k9()
    s = K9_CASES[case]
    sub = s["sub"]
    if s.get("madeup"):
        code = edge.ab_codes(3, sub)
        n_out, blob = None, None
    else:
        data, blob = _frame(24 << 10)
        code, _scal, n_out = ab.pack_host(data, sub)
    ring_in = None
    if s.get("ring"):
        ring_in = torch.from_numpy(np.random.default_rng(sub).integers(
            0, 256, RING, dtype=np.uint8))
    n_sub = code.shape[0]
    pages = 65536 // s["rowb"]
    scal = ((np.arange(n_sub, dtype=np.int32) * (sub // s["rowb"]))
            % pages).reshape(n_sub, 1)
    ring_j0 = (jnp.zeros((pages, s["rowb"]), jnp.bfloat16) if ring_in is None
               else jnp.asarray(ring_to_jax(ring_in).reshape(pages, s["rowb"]),
                                jnp.bfloat16))
    rows_j, ring_j = k9.run_variant(
        jnp.asarray(code), jnp.asarray(scal), ring_j0,
        variant=s["variant"], n_sub=n_sub, sub=sub, rowb=s["rowb"],
        pack=s["pack"])
    got_j = np.asarray(jax.device_get(rows_j)).astype(np.uint8).reshape(-1)
    ring_np = np.asarray(jax.device_get(ring_j)).astype(np.float32)
    ring_k9 = ring_from_jax(ring_np.reshape(256, 256))
    code_t = torch.from_numpy(code)
    for fn in (ab.route_variant_plain, ab.route_variant_jump_plain):
        rows_t, ring_t = fn(code_t, sub, ring_in)
        assert np.array_equal(rows_t.numpy(), got_j), fn.__name__
        assert torch.equal(ring_t, ring_k9), fn.__name__
        if blob is not None:
            assert rows_t.numpy()[:n_out].tobytes() == blob


@pytest.mark.parametrize("seeded", [False, True], ids=["zero-ring", "ring-in"])
@pytest.mark.parametrize("sub", ab.SUBS)
def test_jump_plain_reads_the_ring(sub, seeded):
    """The pointer-jumping decode equals the serial spec on made-up codes
    whose first substeps read the initial ring, in a stream shorter and
    one longer than the ring."""
    ring_in = None
    if seeded:
        ring_in = torch.from_numpy(np.random.default_rng(sub + 1).integers(
            0, 256, RING, dtype=np.uint8))
    for n_sub in (3, -(-3 * RING // sub)):
        code = torch.from_numpy(edge.ab_codes(n_sub, sub, seed=n_sub))
        rows_s, ring_s = ab.route_variant_plain(code, sub, ring_in)
        rows_j, ring_j = ab.route_variant_jump_plain(code, sub, ring_in)
        assert torch.equal(rows_j, rows_s) and torch.equal(ring_j, ring_s)


def _walked_sources(code: np.ndarray, sub: int, ring_in) -> np.ndarray:
    """Each code's state word by walking the ring substep by substep: the
    position last written at each ring offset (-1: the initial ring)."""
    at = np.full(RING, -1, np.int64)
    init = (np.zeros(RING, np.int64) if ring_in is None
            else ring_in.astype(np.int64))
    state = np.empty(code.shape, np.int64)
    for i, row in enumerate(code.astype(np.int64)):
        o = row & 0xFFFF
        ring_ref = (row >> 16) & 1 == 1
        state[i] = np.where(ring_ref,
                            np.where(at[o] >= 0, at[o], ~init[o]),
                            ~((row >> 17) & 255))
        pos = i * sub + np.arange(sub)
        at[pos % RING] = pos
    return state.reshape(-1)


@pytest.mark.parametrize("sub", [3072, 12288])
def test_jump_sources_walk_the_ring(sub):
    """The sources' closed form equals a brute-force walk of the ring at
    substep sizes that do not divide 65536: every code reads a ring offset
    at the edge of some substep's write (its first and last byte, and the
    bytes beside them), so the writes that wrap past the ring's end are
    read from both sides."""
    n_sub = -(-2 * RING // sub) + 1
    edges = sorted({(k * sub + d) % RING for k in range(n_sub + 1)
                    for d in (-2, -1, 0, 1)} | {0, 1, RING - 2, RING - 1})
    offs = np.resize(np.array(edges, np.int64), (n_sub, sub))
    known = np.arange(n_sub * sub).reshape(n_sub, sub) % 251 << 17
    code = np.where(np.arange(sub) % 5 == 4, known,
                    offs | 1 << 16).astype(np.int32)
    rng = np.random.default_rng(sub)
    for ring_in in (None, rng.integers(0, 256, RING, dtype=np.uint8)):
        got = ab.sources_variant_plain(
            torch.from_numpy(code), sub,
            None if ring_in is None else torch.from_numpy(ring_in))
        want = _walked_sources(code, sub, ring_in)
        assert np.array_equal(got.numpy().astype(np.int64), want)
    assert (code >> 16 & 1).any(axis=1).all()


def test_spec_table_maps_every_tpu_name():
    for name in ("base", "rowb128", "pack3", "p3r128", "sub4k", "selfirst",
                 "p3sf3k", "p3sf6k", "p3sf12k", "sf4k"):
        sub, variant = ab.resolve_spec(name)
        assert sub in ab.SUBS and variant == "exact"
    assert ab.resolve_spec("p3sf12k") == (12288, "exact")
    assert ab.resolve_spec("noring@6144") == (6144, "noring")
    for variant in ab.VARIANTS:
        for sub in ab.SUBS:
            assert ab.resolve_spec(f"{variant}@{sub}") == (sub, variant)
    assert {ab.resolve_spec(n)[0] for n in ab.DEFAULT_SPECS} == set(ab.SUBS)
    # every variant is timed; the exact ones at every substep size
    assert {ab.resolve_spec(n)[1] for n in ab.DEFAULT_SPECS} == set(
        ab.VARIANTS)
    for variant in ab.EXACT:
        assert {ab.resolve_spec(n)[0] for n in ab.DEFAULT_SPECS
                if ab.resolve_spec(n)[1] == variant} == set(ab.SUBS)
    assert set(ab.EXACT) <= set(ab.VARIANTS) and set(ab.JUMP) <= set(
        ab.VARIANTS) and set(ab.TRIMMED) <= set(ab.JUMP)
    for bad in ("nope", "exact@1000", "bogus@2048"):
        with pytest.raises(ValueError, match="unknown variant spec"):
            ab.resolve_spec(bad)


def test_wrapper_refuses_what_it_cannot_run():
    code = torch.zeros((1, 2048), dtype=torch.int32)
    with pytest.raises(ValueError, match="sub must be one of"):
        ab.route_variant(code, 1024)
    with pytest.raises(ValueError, match="unknown variant"):
        ab.route_variant(code, 2048, None, "fast")
    with pytest.raises(ValueError, match="timing-only ablation"):
        ab.route_variant(code, 2048, None, "noring")
    for variant in ("serial", "exact", "graph", "nojump"):
        with pytest.raises(ValueError, match="trimmed variants"):
            ab.route_variant(code, 2048, None, variant, 3)
    for variant in ab.TRIMMED:
        with pytest.raises(ValueError, match="needs passes="):
            ab.route_variant(code, 2048, None, variant)
        with pytest.raises(ValueError, match="needs passes="):
            ab.route_variant(code, 2048, None, variant, -1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ab.run(b"", b"")
    assert len(ab.package_text(400_000)) == 400_000


@pytest.mark.parametrize("variant", sorted(set(ab.VARIANTS) - set(ab.EXACT)))
def test_cpu_refuses_every_ablation(variant):
    """A timing-only ablation has no plain version: a CPU tensor is
    refused, whatever the pass count."""
    code = torch.zeros((2, 3072), dtype=torch.int32)
    passes = 1 if variant in ab.TRIMMED else None
    with pytest.raises(ValueError, match="timing-only ablation"):
        ab.route_variant(code, 3072, None, variant, passes)


@pytest.mark.parametrize("variant", ab.EXACT)
def test_cpu_exact_variants_take_the_plain_path(variant):
    """On a CPU tensor every exact variant is the plain spec, and no
    kernel is launched or counted."""
    from lz4tpu_torch import _kernels

    data, blob = _frame(30_000)
    code = torch.from_numpy(ab.pack_host(data, 4096)[0])
    ring_in = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, RING, dtype=np.uint8))
    before = _kernels.LAUNCHES["mxu2_route_ab"]
    rows, ring = ab.route_variant(code, 4096, ring_in, variant)
    assert _kernels.LAUNCHES["mxu2_route_ab"] == before
    want = ab.route_variant_plain(code, 4096, ring_in)
    assert torch.equal(rows, want[0]) and torch.equal(ring, want[1])
    assert rows.numpy()[:len(blob)].tobytes() == blob
