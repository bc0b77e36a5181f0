"""lz4tpu_torch without its native engine, held against lz4tpu without
its own, on the CPU.

Where ``native.available()`` is False, both packages take the numpy
host prep: the fused prep (``fused._prep_fused_numpy``), the mxu2
packer (``mxu2._pack_chain``), the span resolve
(``spans._resolve_ring_bytes_numpy``, one thread) and the numpy dense
cap in ``plan_decode``.  Every array, plan and resolved byte must equal
``lz4tpu``'s, every overflow the same class and message (tolerance 0
throughout), and the port's native prep must equal its numpy prep but
for the order of patch slots within a substep.  End to end, every
decode entry point must return ``lz4tpu.decompress_host``'s bytes
without reaching a native prep, pack or resolve function, and raise
its class and message on a flipped byte and a cut.
"""

import functools
import re

import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.native as jnative
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.native as tnative
import lz4tpu_torch.pipeline as tpl
from lz4tpu import FOR_ALL
from lz4tpu import spans as jsp
from lz4tpu.device import fused as jfu
from lz4tpu.device import mxu2 as jmx
from lz4tpu_torch import device as tdevice
from lz4tpu_torch import dist as tdist
from lz4tpu_torch import spans as tsp
from lz4tpu_torch.device import fused as tfu
from lz4tpu_torch.device import mxu2 as tmx

# the native functions the numpy path replaces: none may run with the
# engine off
NATIVE_PREP = ("prep_fused_chain", "prep_fused_chain_pre",
               "pack_dense2_chain", "resolve_window")


def _frag_text(n: int, seed: int) -> bytes:
    """n bytes of 8192 printable fragments of 3-8 bytes (fused)."""
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    mean = np.mean([len(f) for f in frags])
    picks = rng.integers(0, 8192, int(n / mean * 1.1) + 16)
    return b"".join(frags[i] for i in picks)[:n]


@functools.lru_cache(maxsize=1)
def _checkout_text() -> bytes:
    """The port's own sources, in a fixed order."""
    from lz4tpu_torch import api, dist, serve, stream

    return b"".join(open(m.__file__, "rb").read()
                    for m in (tfu, tmx, tpl, tsp, api, dist, serve, stream))


def _src_text(n: int) -> bytes:
    blob = _checkout_text()
    assert len(blob) >= n
    return blob[:n]


def _word_text(n: int, seed: int) -> bytes:
    """Word tokens of the checkout's text drawn with a seed (as
    chip_smoke.words32m makes its corpus)."""
    toks = sorted(set(re.findall(
        rb"[A-Za-z_][A-Za-z0-9_]*|[^A-Za-z0-9_\s]+|\s+", _checkout_text())))
    rng = np.random.default_rng(seed)
    mean = np.mean([len(t) for t in toks])
    picks = rng.integers(0, len(toks), int(n / mean * 1.1) + 16)
    return b"".join(toks[i] for i in picks)[:n]


def _hand_records():
    """Columns of 1-byte literal sequences: 2048 records a substep,
    beyond the fused engine's SEQ_MAX (576)."""
    s = 5000
    ll = np.ones(s, np.int32)
    zero = np.zeros(s, np.int32)
    buf = np.arange(s, dtype=np.int64).astype(np.uint8)
    return (ll, zero, np.ones(s, np.int32), np.arange(s, dtype=np.int32),
            buf, None)


@functools.lru_cache(maxsize=None)
def _frame(name: str) -> tuple:
    """name -> (compressed, original)."""
    frag = _frag_text(200_000, 11)
    blobs = {
        "frag": (frag, {}),
        "frag-long": (_frag_text(560_000, 12), {}),
        "words": (_word_text(160_000, 15), {}),
        "src": (_src_text(120_000), {}),
        "legacy": (frag, dict(frame_format="legacy")),
        "chains": (_frag_text(300_000, 5),
                   dict(block_independence=True, block_max_code=5)),
        "chains-small": (_frag_text(100_000, 6),
                         dict(block_independence=True, block_max_code=4)),
        "src-chains": (_src_text(200_000),
                       dict(block_independence=True, block_max_code=4)),
        "run": (b"a" * 300_000, {}),
        "rle7": (b"abcdefg" * 20_000, {}),
        # lz4tpu's fused module: in-substep chains no deeper than 64
        # links, but more than 256 of them in a substep
        "jax-src": (open(jfu.__file__, "rb").read()[:128 << 10], {}),
    }
    blob, kw = blobs[name]
    return lz4tpu.compress(blob, **kw), blob


def _table(data: bytes):
    """The port's sequence table and chain ranges of ``data``."""
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    t = tpl.build_seq_table(buf, parsed, lz4tpu_torch.FOR_ALL, data)
    ranges = [(c.seq_lo, c.seq_hi) for c in tpl._chains_of(t)]
    return buf, t, ranges


def _cols(name: str):
    """(lit_len, match_len, match_off, lit_src, buf, chain_ranges)."""
    if name == "records":
        return _hand_records()
    buf, t, ranges = _table(_frame(name)[0])
    return (t.lit_len, t.match_len, t.match_off, t.lit_src, buf,
            ranges if len(ranges) > 1 else None)


PREP_CASES = ["frag", "words", "src", "legacy", "chains", "src-chains",
              "run", "rle7", "jax-src", "records"]


@pytest.fixture
def engine_off(monkeypatch):
    """Both packages without their native engine."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.fixture
def no_native_prep(engine_off, monkeypatch):
    """The port's engine off, and its native prep, pack and resolve
    functions raising: a call that still reaches one fails the test."""
    def refuse(name):
        def f(*_a, **_k):
            raise AssertionError(f"native.{name} ran with the engine off")
        return f

    for name in NATIVE_PREP:
        monkeypatch.setattr(tnative, name, refuse(name))


def _outcome(fn):
    try:
        return fn()
    except (tfu.FusedOverflow, jfu.FusedOverflow) as e:
        return e


def _assert_same_prep(a, b, patch_order=True):
    """FusedPrep ``a`` equals ``b`` field by field; with
    ``patch_order=False`` the patches compare as multisets a substep."""
    assert a.n_sub == b.n_sub
    n = a.n_sub
    for f in ("lits", "winq", "scal", "seqrec"):
        assert np.array_equal(np.asarray(getattr(a, f))[:max(n, 1)],
                              np.asarray(getattr(b, f))[:max(n, 1)]), f
    pa = np.asarray(a.patch)[:max(n, 1)].reshape(max(n, 1), -1)
    pb = np.asarray(b.patch)[:max(n, 1)].reshape(max(n, 1), -1)
    if not patch_order:
        pa, pb = np.sort(pa, axis=1), np.sort(pb, axis=1)
    assert np.array_equal(pa, pb)
    for f in ("n_patches", "n_seq_recs", "out_spans", "max_off",
              "max_recs", "max_patches"):
        assert getattr(a, f) == getattr(b, f), f


# ---------------------------------------------------------------------------
# fused prep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PREP_CASES)
def test_numpy_prep_matches_jax(engine_off, name):
    *cols, ranges = _cols(name)
    ours = _outcome(lambda: tfu.prep_fused(*cols, chain_ranges=ranges))
    theirs = _outcome(lambda: jfu.prep_fused(*cols, chain_ranges=ranges))
    direct = _outcome(lambda: tfu._prep_fused_numpy(*cols, ranges))
    if isinstance(theirs, Exception):
        assert isinstance(ours, tfu.FusedOverflow)
        assert isinstance(direct, tfu.FusedOverflow)
        assert str(ours) == str(theirs) == str(direct)
        return
    _assert_same_prep(ours, theirs)
    _assert_same_prep(direct, theirs)


def test_overflow_messages_cover_each_budget(engine_off):
    """The overflow cases of PREP_CASES reach four different budgets
    (so the message test above compares four messages, not one)."""
    msgs = set()
    for name in ("src", "jax-src", "run", "records"):
        *cols, ranges = _cols(name)
        with pytest.raises(tfu.FusedOverflow) as e:
            tfu.prep_fused(*cols, chain_ranges=ranges)
        msgs.add(re.sub(r"\d+", "N", str(e.value)))
    assert msgs == {"N patches per substep (budget N)",
                    "patch chain deeper than N",
                    "match spans cross >N substeps",
                    "N seq records per substep (budget N)"}


@pytest.mark.parametrize("name", ["frag", "legacy", "chains",
                                  "chains-small"])
def test_native_prep_matches_numpy(name):
    """The port's native prep against its numpy prep: equal but for the
    order of patch slots within a substep (the kernel's scatter does
    not depend on it), as lz4tpu's native prep against its own."""
    *cols, ranges = _cols(name)
    assert tnative.available()
    a = tfu._prep_fused_native(*cols, ranges, pooled=False)
    b = tfu._prep_fused_numpy(*cols, ranges)
    _assert_same_prep(a, b, patch_order=False)


def test_prep_fused_with_pre_takes_numpy_when_engine_off(no_native_prep):
    """``pre`` (the scan's phase-1 tuple) is the native prep's input: with
    the engine off the numpy prep runs and equals lz4tpu's."""
    data = _frame("frag")[0]
    buf = np.frombuffer(data, np.uint8)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    t = jpl.build_seq_table(buf, parsed, FOR_ALL, data)
    cols = (t.lit_len, t.match_len, t.match_off, t.lit_src, buf)
    pre = (np.zeros(1, np.int64),) * 4     # never read
    _assert_same_prep(tfu.prep_fused(*cols, pre=pre),
                      jfu.prep_fused(*cols))


@pytest.mark.parametrize("name", PREP_CASES)
def test_max_patches_per_substep_matches_jax(name):
    *cols, ranges = _cols(name)
    ll, ml, mo = cols[:3]
    got = tfu.max_patches_per_substep(ll, ml, mo, ranges)
    assert got == jfu.max_patches_per_substep(ll, ml, mo, ranges)
    if name == "run":
        assert got == 1 << 30
    elif name in ("frag", "legacy", "chains"):
        assert got == tfu._prep_fused_numpy(*cols, ranges).max_patches


def test_empty_chain_ranges_match_jax(engine_off):
    """A chain range with no sequences beside real ones: the same
    budget count, prep and pack as lz4tpu's (an empty span, no
    substeps)."""
    *cols, ranges = _cols("chains-small")
    ranges = [(0, 0)] + ranges
    ll, ml, mo = cols[:3]
    assert (tfu.max_patches_per_substep(ll, ml, mo, ranges)
            == jfu.max_patches_per_substep(ll, ml, mo, ranges))
    _assert_same_prep(tfu.prep_fused(*cols, chain_ranges=ranges),
                      jfu.prep_fused(*cols, chain_ranges=ranges))
    ours = tmx.pack_dense2(*cols, chain_ranges=ranges)
    theirs = jmx.pack_dense2(*cols, chain_ranges=ranges)
    assert ours.out_spans == theirs.out_spans
    assert ours.out_spans[0] == (0, 0, 0, 0)
    assert np.array_equal(ours.code, theirs.code)
    empty = np.zeros(0, np.int32)
    code, n_out = tmx._pack_chain(empty, empty, empty, empty, cols[4])
    assert n_out == 0 and code.size == 0


# ---------------------------------------------------------------------------
# mxu2 packer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["src", "words", "frag", "run"])
def test_pack_chain_matches_jax_and_native(name):
    ll, ml, mo, ls, buf, _r = _cols(name)
    code, n_out = tmx._pack_chain(ll, ls, ml, mo, buf)
    want, n_want = jmx._pack_chain(ll, ls, ml, mo, buf)
    assert n_out == n_want
    assert np.array_equal(code, want)
    native = np.zeros(n_out + 16, np.int32)
    tnative.pack_dense2_chain(buf, ll, ls, ml, mo, out=native)
    assert np.array_equal(code, native[:n_out])


@pytest.mark.parametrize("name", ["src", "src-chains", "words", "chains"])
def test_pack_dense2_engine_off_matches_jax(no_native_prep, name):
    *cols, ranges = _cols(name)
    ours = tmx.pack_dense2(*cols, chain_ranges=ranges)
    theirs = jmx.pack_dense2(*cols, chain_ranges=ranges)
    assert ours.n_sub == theirs.n_sub
    assert ours.out_spans == theirs.out_spans
    assert np.array_equal(ours.code, theirs.code)
    assert np.array_equal(ours.scal, theirs.scal)


def test_pack_dense2_numpy_equals_native(monkeypatch):
    *cols, ranges = _cols("src-chains")
    native = tmx.pack_dense2(*cols, chain_ranges=ranges)
    monkeypatch.setattr(tnative, "available", lambda: False)
    plain = tmx.pack_dense2(*cols, chain_ranges=ranges)
    assert np.array_equal(native.code, plain.code)
    assert np.array_equal(native.scal, plain.scal)


# ---------------------------------------------------------------------------
# plan_decode
# ---------------------------------------------------------------------------

def _plan_summary(plan):
    return {
        "sparse": [(c.seq_lo, c.seq_hi) for c, _p in plan.sparse],
        "fused": [(c.seq_lo, c.seq_hi) for c in plan.fused_chains],
        "dense": [(c.seq_lo, c.seq_hi) for c in plan.dense_chains],
        "other": [(c.seq_lo, c.seq_hi) for c in plan.other],
    }


@pytest.mark.parametrize("engine", ["on", "off"])
@pytest.mark.parametrize("name", ["chains", "src-chains"])
def test_plan_decode_engines_match_jax(monkeypatch, engine, name):
    """Chains of 3-256 KiB against the numpy dense cap patched to 48 KiB
    (the native cap stays 1 GiB): without the engine the numpy cap
    sends the chains above 48 KiB to the resolver, with it none goes
    there; the engine a chain takes, and the prep and pack, equal
    lz4tpu's."""
    for mod in (tpl, jpl):
        monkeypatch.setattr(mod, "_DENSE_MAX_CHAIN_OUT_NUMPY", 48 << 10)
    if engine == "off":
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    data = _frame(name)[0]
    buf = np.frombuffer(data, np.uint8)
    t_st, j_st = tpl.DecodeStats(), jpl.DecodeStats()
    t_parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    t_table = tpl.build_seq_table(buf, t_parsed, lz4tpu_torch.FOR_ALL, data)
    t_plan = tpl.plan_decode(buf, t_parsed, t_table, t_st)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    j_table = jpl.build_seq_table(buf, parsed, FOR_ALL, data)
    j_plan = jpl.plan_decode(buf, parsed, j_table, j_st)
    assert _plan_summary(t_plan) == _plan_summary(j_plan)
    assert t_st.engine_chains == j_st.engine_chains
    n_big = 1 if name == "chains" else 3
    assert len(t_plan.other) == (n_big if engine == "off" else 0)
    if t_plan.fused_prep is not None:
        _assert_same_prep(t_plan.fused_prep, j_plan.fused_prep)
    if t_plan.dense_pack is not None:
        assert np.array_equal(t_plan.dense_pack.packed().code,
                              j_plan.dense_pack.code)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _chain(name):
    ll, ml, mo, ls, buf, _r = _cols(name)
    return ll, ml, mo, ls, buf


@pytest.mark.parametrize("name", ["frag", "words", "src", "run"])
def test_resolve_ring_bytes_engine_off_matches_jax(no_native_prep, name):
    ll, ml, mo, ls, buf = _chain(name)
    blob = _frame(name)[1]
    n_out = len(blob)
    for boundary in (tsp.RING, n_out // 2, n_out - 1, n_out):
        got = tsp.resolve_ring_bytes(ll, ml, mo, ls, buf, boundary)
        want = jsp.resolve_ring_bytes(ll, ml, mo, ls, buf, boundary)
        assert np.array_equal(got, want)
        lo = max(boundary - tsp.RING, 0)
        assert got[tsp.RING - (boundary - lo):].tobytes() == blob[lo:boundary]


def test_resolve_overflow_engine_off_matches_jax(no_native_prep):
    ll, ml, mo, ls, buf = _chain("run")
    with pytest.raises(tsp.SpanResolveOverflow) as et:
        tsp.resolve_ring_bytes(ll, ml, mo, ls, buf, 200_000, work_max=1000)
    with pytest.raises(jsp.SpanResolveOverflow) as ej:
        jsp.resolve_ring_bytes(ll, ml, mo, ls, buf, 200_000, work_max=1000)
    assert str(et.value) == str(ej.value)


def test_resolve_rings_one_thread_engine_off(no_native_prep, monkeypatch):
    """Without the engine the boundaries resolve in order on the calling
    thread (the numpy walk holds the interpreter lock), as lz4tpu's."""
    import concurrent.futures

    def no_pool(*_a, **_k):
        raise AssertionError("a thread pool with the engine off")

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", no_pool)
    monkeypatch.setattr(tnative, "pack_threads", lambda: 8)
    ll, ml, mo, ls, buf = _chain("frag")
    bounds = [tsp.RING, 2 * tsp.RING, 3 * tsp.RING]
    got = tsp.resolve_rings(ll, ml, mo, ls, buf, bounds)
    want = jsp.resolve_rings(ll, ml, mo, ls, buf, bounds)
    assert len(got) == len(want) == 3
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_split_fused_chain_engine_off_matches_jax(no_native_prep):
    data = _frame("frag-long")[0]
    buf, t, _r = _table(data)
    chain = tpl._chains_of(t)[0]
    parsed = jpl.parse_frames(buf, FOR_ALL)
    j_table = jpl.build_seq_table(buf, parsed, FOR_ALL, data)
    ours = tsp.split_fused_chain(t, chain, buf, 3)
    theirs = jsp.split_fused_chain(j_table, jpl._chains_of(j_table)[0],
                                   buf, 3)
    assert len(ours[1]) == len(theirs[1]) == 3
    for a, b in zip(ours[1], theirs[1]):
        _assert_same_prep(a, b)
    assert ours[2][0] is None and theirs[2][0] is None
    for a, b in zip(ours[2][1:], theirs[2][1:]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# list decoders
# ---------------------------------------------------------------------------

def test_decode_fused_matches_jax_interpret(engine_off):
    *cols, ranges = _cols("chains-small")
    assert len(ranges) == 2                 # 64 KiB and 34,464 B
    ours = tfu.decode_fused(tfu.prep_fused(*cols, chain_ranges=ranges),
                            device="cpu")
    theirs = jfu.decode_fused(jfu.prep_fused(*cols, chain_ranges=ranges),
                              interpret=True)
    assert ours == theirs
    blob = _frame("chains-small")[1]
    assert ours == [(0, blob[:64 << 10]), (1, blob[64 << 10:])]


def test_decode_dense2_matches_jax_interpret(engine_off):
    *cols, ranges = _cols("src-chains")
    ranges = ranges[:2]
    ours = tmx.decode_dense2(tmx.pack_dense2(*cols, chain_ranges=ranges),
                             device="cpu")
    theirs = jmx.decode_dense2(jmx.pack_dense2(*cols, chain_ranges=ranges),
                               interpret=True)
    assert ours == theirs
    assert b"".join(b for _c, b in ours) == _frame("src-chains")[1][:128 << 10]


@pytest.mark.parametrize("fn", ["decode_fused", "decode_dense2"])
def test_list_decoders_default_to_the_card(fn):
    """``device`` defaults to "cuda" and raises without CUDA, as the
    port's other entry points do (the decision is made at call time)."""
    empty = (tfu.FusedPrep(
        seqrec=np.zeros((1, 2, 8, tfu.SEQ_MAX // 8), np.int32),
        lits=np.zeros((1, 32, 256), np.uint8), winq=np.zeros(1, np.int32),
        scal=np.zeros((1, 8), np.int32),
        patch=np.zeros((1, 8, tfu.PATCH_MAX // 8), np.int32), n_sub=0,
        n_patches=0, n_seq_recs=0, out_spans=[(0, 0, 0, 0)])
        if fn == "decode_fused" else
        tmx.DensePack2(code=np.zeros((0, tmx.SUB), np.int32),
                       scal=np.zeros((0, 1), np.int32), n_sub=0,
                       out_spans=[(0, 0, 0, 0)]))
    decode = getattr(tfu if fn == "decode_fused" else tmx, fn)
    assert decode(empty, device="cpu") == [(0, b"")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            decode(empty)


def test_native_engine_helper_is_gone():
    assert not hasattr(tdevice, "native_engine")


# ---------------------------------------------------------------------------
# end to end with the engine off
# ---------------------------------------------------------------------------

E2E = ["frag", "words", "src", "legacy", "chains", "src-chains", "run"]


@pytest.mark.parametrize("verify", ["host", "device", "none"])
@pytest.mark.parametrize("name", E2E)
def test_decompress_to_device_engine_off(no_native_prep, name, verify):
    data, blob = _frame(name)
    want = lz4tpu.decompress_host(data)
    assert want == blob
    before = tpl.HOST_FALLBACKS
    got = lz4tpu_torch.decompress_to_device(data, device="cpu",
                                            verify=verify)
    assert got.numpy().tobytes() == want
    assert tpl.HOST_FALLBACKS == before


@pytest.mark.parametrize("name", E2E)
def test_decompress_device_engine_off(no_native_prep, name):
    data, blob = _frame(name)
    before = tpl.HOST_FALLBACKS
    st = tpl.DecodeStats()
    assert lz4tpu_torch.decompress_device(data, device="cpu",
                                          stats=st) == blob
    assert tpl.HOST_FALLBACKS == before
    want = {"frag": {"fused"}, "words": {"dense"}, "legacy": {"fused"},
            "chains": {"fused"}, "src": {"dense"},
            "src-chains": {"dense", "sparse"}, "run": {"sparse"}}[name]
    assert set(st.engine_chains) == want


def test_session_engine_off(no_native_prep):
    names = ["frag", "src", "legacy", "chains", "run"]
    before = tpl.HOST_FALLBACKS
    with lz4tpu_torch.DecodeSession(max_inflight=len(names),
                                    device="cpu") as s:
        tickets = [s.submit(_frame(n)[0]) for n in names]
        got = [t.result() for t in tickets]
    assert got == [_frame(n)[1] for n in names]
    assert tpl.HOST_FALLBACKS == before


@pytest.mark.parametrize("name", ["frag-long", "src", "legacy", "chains",
                                  "src-chains"])
def test_decompress_sharded_engine_off(no_native_prep, name):
    data, blob = _frame(name)
    mesh = tdist.make_mesh(4, "cpu")
    before = tpl.HOST_FALLBACKS
    assert tdist.decompress_sharded(data, mesh) == blob
    assert tpl.HOST_FALLBACKS == before


def test_sharded_spans_resolve_in_numpy(no_native_prep):
    """frag-long on four entries splits into span units whose rings the
    numpy walk resolves (the tier the card's four-entry mesh takes)."""
    data = _frame("frag-long")[0]
    buf, t, _r = _table(data)
    assert tdist._use_chains(t, 4)
    units, split = tdist._work_units(t, buf, 4)
    assert split
    assert sum(u.ring is not None for u in units
               if isinstance(u, tdist.SpanUnit)) == 3


def _corruptions():
    data, _blob = _frame("frag")
    flip = bytearray(lz4tpu.compress(_frame("frag")[1], block_checksum=True,
                                     block_max_code=4))
    flip[300] ^= 0x40
    return {"flipped": bytes(flip), "cut": data[:-37]}


@pytest.mark.parametrize("entry", ["to_device", "device", "session",
                                   "sharded"])
@pytest.mark.parametrize("what", ["flipped", "cut"])
def test_errors_engine_off_match_lz4tpu(no_native_prep, what, entry):
    data = _corruptions()[what]
    with pytest.raises(lz4tpu.Lz4Error) as ej:
        lz4tpu.decompress_host(data)
    with pytest.raises(lz4tpu_torch.Lz4Error) as et:
        if entry == "to_device":
            lz4tpu_torch.decompress_to_device(data, device="cpu",
                                              verify="device")
        elif entry == "device":
            lz4tpu_torch.decompress_device(data, device="cpu")
        elif entry == "session":
            with lz4tpu_torch.DecodeSession(device="cpu") as s:
                s.submit(data).result()
        else:
            tdist.decompress_sharded(data, tdist.make_mesh(4, "cpu"))
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)
