"""lz4tpu_torch's device encoder held against lz4tpu's on the CPU.

The same seeded numpy inputs go through ``lz4tpu.device.encode`` (XLA on
the CPU) and ``lz4tpu_torch.device.encode`` (PyTorch ops with
``device="cpu"``): every function element for element, the frames of
``compress(backend="device"|"device-emit")`` and of
``dist.compress_sharded`` byte for byte.  Tolerance 0: bytes and
integers.

XLA compiles each padded size once, so the inputs keep to a few sizes
(n_pad 1024, 2048, 6144, 66560, 65536 and 131072) and the JAX side of
each is computed once per module (the ``ref`` fixture).  The quality
checks compress in-repo text that the port does not edit (SURVEY.md and
the JAX package's sources), never ``/root/reference``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.dist as jd
from lz4tpu.device import encode as je

import lz4tpu_torch
import lz4tpu_torch.dist as td
from lz4tpu_torch.block import decode_block, decode_block_ring_py
from lz4tpu_torch.device import encode as te
from lz4tpu_torch.native import emit_quantized

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = "cpu"


def _text(n: int) -> bytes:
    """In-repo text the port never edits: SURVEY.md, then the JAX
    package's own sources."""
    blob = (REPO / "SURVEY.md").read_bytes() + b"".join(
        p.read_bytes() for p in sorted((REPO / "lz4tpu").glob("*.py")))
    assert len(blob) >= n
    return blob[:n]


def _rand(n: int, seed: int, lo: int = 0, hi: int = 256) -> bytes:
    return np.random.default_rng(seed).integers(
        lo, hi, n, dtype=np.uint8).tobytes()


def _window_case() -> np.ndarray:
    """66,560 random bytes with two 16-byte patterns repeated exactly
    65,535 and 65,536 bytes later: the first pair is in the window, the
    second just outside it."""
    d = np.frombuffer(_rand(66_560, 5), np.uint8).copy()
    a = np.frombuffer(b"IN-WINDOW-EDGE!!", np.uint8)
    b = np.frombuffer(b"OUT-OF-WINDOW!!!", np.uint8)
    d[100:116] = a
    d[100 + 65_535:116 + 65_535] = a
    d[300:316] = b
    d[300 + 65_536:316 + 65_536] = b
    return d


def _inputs() -> dict:
    text = _text(6000)
    mixed = text[:2000] + bytes(3000) + text[2000:3000]
    return {
        "empty": b"",
        **{f"n{n}": _text(n) for n in (7, 8, 15, 16, 1023, 1024, 1025)},
        # grams of high bytes are negative int32 words: the signed order
        "highbit": _rand(6000, 1, 0xF0, 0x100),
        "ff-runs": (b"\xff" * 700 + _rand(300, 2, 0xFE, 0x100)) * 6,
        # one gram group thousands long crosses the 512-wide scan blocks
        "zeros": mixed,
        "text": text,
        "low": _rand(6000, 3, 0, 3),
        "window": _window_case().tobytes(),
    }


INPUTS = _inputs()
NAMES = sorted(INPUTS)
# the ladder and the depth-4 chain (a compile each per size) on these
DEEP = ("highbit", "zeros", "text", "window")


@pytest.fixture(scope="module")
def ref():
    """lz4tpu's result for a key, computed once per module."""
    memo = {}

    def get(key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    return get


def _arr(name: str) -> np.ndarray:
    return np.frombuffer(INPUTS[name], np.uint8)


def _padded(name: str):
    d = _arr(name)
    n = d.size
    n_pad = (n + 1023) // 1024 * 1024
    buf = np.zeros(n_pad, np.uint8)
    buf[:n] = d
    return buf, n, n_pad


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the building blocks
# ---------------------------------------------------------------------------

def test_gram_words_wrap_as_int32():
    b = np.frombuffer(b"\xff\xff\xff\xff\x00\x80\x7f\xff" * 40
                      + _rand(700, 4), np.uint8)
    got = te._gram_words(torch.from_numpy(b.astype(np.int32)))
    want = je._gram_words(jnp.asarray(b.astype(np.int32)))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        _equal(g, w)
    assert int(got[0][0]) == -1


@pytest.mark.parametrize("n_keys", [1, 2, 3, 8])
def test_sort_order_is_lexicographic_and_signed(n_keys):
    rng = np.random.default_rng(n_keys)
    pool = np.array([-2**31, -2**31 + 1, -65536, -1, 0, 1, 255,
                     2**31 - 1], np.int32)
    keys = [pool[rng.integers(0, pool.size, 3000)] for _ in range(n_keys)]
    pos = np.arange(3000, dtype=np.int32)
    want = jax.lax.sort(tuple(jnp.asarray(k) for k in keys)
                        + (jnp.asarray(pos),), num_keys=n_keys + 1)[-1]
    got = te._sort_order([torch.from_numpy(k) for k in keys])
    _equal(got.to(torch.int32), want)


def test_sort_order_batched_rows_sort_alone():
    rng = np.random.default_rng(9)
    keys = [rng.integers(-3, 3, (3, 2048)).astype(np.int32)
            for _ in range(2)]
    got = te._sort_order([torch.from_numpy(k) for k in keys])
    for r in range(3):
        one = te._sort_order([torch.from_numpy(k[r].copy()) for k in keys])
        assert torch.equal(got[r], one)


@pytest.mark.parametrize("shape,s", [((4096,), 1), ((4096,), 300),
                                     ((8, 512), 7), ((8, 512), 256)])
def test_pshift(shape, s):
    x = np.random.default_rng(s).integers(-9, 9, shape).astype(np.int32)
    _equal(te._pshift(torch.from_numpy(x), s, 0),
           je._pshift(jnp.asarray(x), s, np.int32(0)))
    f = x > 0
    _equal(te._pshift(torch.from_numpy(f), s, False),
           je._pshift(jnp.asarray(f), s, False))


@pytest.mark.parametrize("n", [512, 1000, 1536, 8192])
def test_blocked_cumsum(n):
    x = (np.random.default_rng(n).random(n) < 0.3).astype(np.int32)
    _equal(te._blocked_cumsum(torch.from_numpy(x)),
           je._blocked_cumsum(jnp.asarray(x)))


def _segments(n: int, p: float, seed: int):
    rng = np.random.default_rng(seed)
    v = rng.permutation(n).astype(np.int32)
    f = rng.random(n) < p
    f[0] = True
    return v, f


@pytest.mark.parametrize("n,p", [(512, 0.05), (1000, 0.01), (4096, 0.002),
                                 (8192, 0.0005), (8192, 0.3)])
def test_segmented_minima(n, p):
    """Groups hundreds and thousands long cross the 512-wide blocks."""
    v, f = _segments(n, p, n)
    _equal(te._seg_min_prefix(torch.from_numpy(v), torch.from_numpy(f)),
           je._seg_min_prefix(jnp.asarray(v), jnp.asarray(f)))
    _equal(te._seg_min_suffix(torch.from_numpy(v), torch.from_numpy(f)),
           je._seg_min_suffix(jnp.asarray(v), jnp.asarray(f)))


def test_combine_levels_merges_runs():
    """Levels with long equal stretches, so runs double up to the cap;
    shifts beyond the buffer wrap as jnp.roll's do."""
    n_pad, n_real = 4096, 4000
    rng = np.random.default_rng(12)
    levels = []
    for k in (4, 8, 16, 32):
        d = np.repeat(rng.choice([0, 0, 3, 7, 65535], n_pad // 256), 256)
        levels.append((k, d.astype(np.int32)))
    got = te._combine_levels([(k, torch.from_numpy(d)) for k, d in levels],
                             n_real, n_pad)
    want = je._combine_levels([(k, jnp.asarray(d)) for k, d in levels],
                              np.int32(n_real), n_pad)
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[0].numpy().max() > 32


def test_deltas_to_positions():
    d = np.random.default_rng(13).integers(0, 70, (2, 5000)).astype(
        np.uint16)
    _equal(te.deltas_to_positions(d), je.deltas_to_positions(d))


# ---------------------------------------------------------------------------
# the three passes, raw and through their wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_compact_candidates(name, ref):
    d = _arr(name)
    _equal(te.compact_candidates(d, device=CPU),
           ref(("compact", name), lambda: je.compact_candidates(d)))
    if d.size >= 8:
        buf, _n, n_pad = _padded(name)
        _equal(te._candidates_compact_device(torch.from_numpy(buf),
                                             n_pad=n_pad),
               ref(("compact-raw", name),
                   lambda: je._candidates_compact_device(
                       jnp.asarray(buf), n_pad=n_pad)))


@pytest.mark.parametrize("name", NAMES)
def test_match_candidates(name, ref):
    d = _arr(name)
    _equal(te.match_candidates(d, device=CPU),
           ref(("depth1", name), lambda: je.match_candidates(d)))
    if name in DEEP:
        _equal(te.match_candidates(d, 4, device=CPU),
               ref(("depth4", name), lambda: je.match_candidates(d, 4)))
        buf, _n, n_pad = _padded(name)
        _equal(te._candidates_device(torch.from_numpy(buf), n_pad=n_pad,
                                     k_cands=4),
               ref(("depth4-raw", name), lambda: je._candidates_device(
                   jnp.asarray(buf), n_pad=n_pad, k_cands=4)))


@pytest.mark.parametrize("name", NAMES)
def test_emit_inputs(name, ref):
    d = _arr(name)
    got = te.emit_inputs(d, device=CPU)
    want = ref(("emit", name), lambda: je.emit_inputs(d))
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("name", DEEP)
@pytest.mark.parametrize("scheme", ["_emit_inputs_device",
                                    "_emit_inputs_device_ladder"])
def test_emit_schemes_raw(scheme, name, ref):
    buf, n, n_pad = _padded(name)
    got = getattr(te, scheme)(torch.from_numpy(buf), n, n_pad=n_pad)
    want = ref((scheme, name), lambda: getattr(je, scheme)(
        jnp.asarray(buf), np.int32(n), n_pad=n_pad))
    for g, w in zip(got, want):
        _equal(g, w)


def test_window_edge_is_65535():
    d = _window_case()
    delta = te.compact_candidates(d, device=CPU)
    assert delta[0, 100 + 65_535] == 65_535
    assert delta[1, 100 + 65_535] == 65_535
    assert delta[0, 300 + 65_536] == delta[1, 300 + 65_536] == 0
    elen, eoff = te.emit_inputs(d, device=CPU)
    assert eoff[100 + 65_535] == 65_535 and elen[100 + 65_535] >= 16
    assert elen[300 + 65_536] == 0
    cand = te.match_candidates(d, device=CPU)
    assert cand[0, 100 + 65_535] == 100 and cand[0, 300 + 65_536] == -1


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("backend", ["device", "device-emit"])
def test_block_bytes_equal(backend, name, ref):
    src = INPUTS[name]
    fn_t, fn_j = ((te.compress_block_device, je.compress_block_device)
                  if backend == "device" else
                  (te.compress_block_device_emit,
                   je.compress_block_device_emit))
    got = fn_t(src, device=CPU)
    assert got == ref((backend, name), lambda: fn_j(src))
    if src:
        assert decode_block(np.frombuffer(got, np.uint8), len(src)) == src


def test_block_with_history_bytes_equal(ref):
    hist = _text(57_344)                 # joined, 64 KiB: one n_pad
    src = hist[1000:7192] + _rand(2000, 6)
    for fn_t, fn_j in ((te.compress_block_device, je.compress_block_device),
                       (te.compress_block_device_emit,
                        je.compress_block_device_emit)):
        assert fn_t(src, hist=hist, device=CPU) == fn_j(src, hist=hist)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

# 64 KiB of text and 64 KiB of random bytes: with 64 KiB blocks the
# second is stored; every block pads to 65536 or 131072 bytes
FRAME_PAYLOAD = _text(65_536) + _rand(65_536, 7)
FRAME_CASES = {
    "default": {},
    "bsum-size": dict(block_checksum=True, content_size=True),
    "64k-linked": dict(block_max_code=4),
    "64k-indep": dict(block_max_code=4, block_independence=True,
                      block_checksum=True),
    "no-content-sum": dict(block_max_code=4, content_checksum=False),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
@pytest.mark.parametrize("backend", ["device", "device-emit"])
def test_frame_bytes_equal(backend, case):
    kw = FRAME_CASES[case]
    got = lz4tpu_torch.compress(FRAME_PAYLOAD, backend=backend, device=CPU,
                                **kw)
    assert got == lz4tpu.compress(FRAME_PAYLOAD, backend=backend, **kw)
    assert lz4tpu_torch.decompress(got, backend="host") == FRAME_PAYLOAD


@pytest.mark.parametrize("backend", ["device", "device-emit"])
def test_frame_empty_and_tiny(backend):
    for payload in (b"", b"a", b"abcdefg"):
        assert lz4tpu_torch.compress(payload, backend=backend, device=CPU) \
            == lz4tpu.compress(payload, backend=backend)


def test_no_cuda_raises(monkeypatch):
    """device="cuda" without CUDA raises; nothing encodes on the CPU in
    its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _arr("text")
    for call in (lambda: lz4tpu_torch.compress(b"abc" * 9, backend="device"),
                 lambda: lz4tpu_torch.compress(b"abc" * 9,
                                               backend="device-emit"),
                 lambda: td.compress_sharded(b"abc" * 9),
                 lambda: te.compact_candidates(d),
                 lambda: te.match_candidates(d),
                 lambda: te.emit_inputs(d),
                 lambda: te.compress_block_device(b"abc" * 9)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert lz4tpu_torch.compress(b"abc" * 9, backend="host") == \
        lz4tpu.compress(b"abc" * 9)


# ---------------------------------------------------------------------------
# the sharded encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
def test_compress_sharded_bytes_equal(n, ref):
    kw = dict(block_max_code=4)
    got = td.compress_sharded(FRAME_PAYLOAD, td.make_mesh(n, CPU), **kw)
    assert got == ref(("sharded", n), lambda: jd.compress_sharded(
        FRAME_PAYLOAD, jd.make_mesh(n), **kw))
    assert got == lz4tpu_torch.compress(FRAME_PAYLOAD, backend="device",
                                        device=CPU, **kw)


def test_compress_sharded_frame_options():
    kw = dict(block_max_code=4, block_independence=True,
              block_checksum=True, content_size=True,
              content_checksum=False)
    got = td.compress_sharded(FRAME_PAYLOAD, td.make_mesh(4, CPU), **kw)
    assert got == jd.compress_sharded(FRAME_PAYLOAD, jd.make_mesh(4), **kw)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_compress_sharded_empty(n):
    got = td.compress_sharded(b"", td.make_mesh(n, CPU))
    assert got == jd.compress_sharded(b"", jd.make_mesh(n))
    assert got == lz4tpu_torch.compress(b"", backend="device", device=CPU)
    assert lz4tpu_torch.decompress(got) == b""


def test_padding_never_referenced():
    """The staging buffer zero-pads before the real history; the
    emitter's backward match extension must not walk into it (it would
    emit back-references before the frame start)."""
    payload = (b"\x00ABCDEFGH\x00\x00ABCDEFGH"
               + b"the rest of the payload " * 40)
    frame = td.compress_sharded(payload, td.make_mesh(4, CPU),
                                block_max_code=4)
    assert lz4tpu_torch.decompress(frame) == payload
    assert frame == lz4tpu_torch.compress(payload, backend="device",
                                          block_max_code=4, device=CPU)
    assert frame == jd.compress_sharded(payload, jd.make_mesh(4),
                                        block_max_code=4)


# ---------------------------------------------------------------------------
# quality (the JAX package's own checks, on in-repo text)
# ---------------------------------------------------------------------------

def test_compact_ratio_close_to_depth8():
    """The 4 B/byte compact stream compresses within 2% of the 32 B/byte
    depth-8 chain on text."""
    text = (REPO / "SURVEY.md").read_bytes() * 6
    compact = te.compress_block_device(text, device=CPU)
    deep = te.compress_block_device(text, k_cands=8, device=CPU)
    assert len(compact) <= len(deep) * 1.02
    assert decode_block(np.frombuffer(compact, np.uint8), len(text)) == text


def test_deeper_candidates_improve_ratio():
    rng = np.random.default_rng(15)
    words = [b"red", b"green", b"blue", b"cyan"]
    payload = b" ".join(words[int(rng.integers(0, 4))]
                        for _ in range(50_000))
    s1 = te.compress_block_device(payload, k_cands=1, device=CPU)
    s4 = te.compress_block_device(payload, k_cands=4, device=CPU)
    assert len(s4) <= len(s1)
    assert decode_block(np.frombuffer(s4, np.uint8), len(payload)) == payload


def _mixed() -> bytes:
    rng = np.random.default_rng(44)
    return b"".join(b"var%d = value_%d; " % (i % 97, i % 31)
                    for i in range(6000)) + rng.integers(
        0, 256, 8000, dtype=np.uint8).tobytes()


def test_one_sort_scheme_matches_exact_ladder_quality():
    """The one-sort scheme stays within 2% of the exact per-level
    ladder's sizes, on ~100 KiB of text (the window edge matters)."""
    for payload in (_text(100 * 1024), _mixed()):
        data = np.frombuffer(payload, np.uint8)
        n = data.size
        n_pad = (n + 1023) // 1024 * 1024
        buf = torch.zeros(n_pad, dtype=torch.uint8)
        buf[:n] = torch.from_numpy(data.copy())

        def size(fn):
            elen, eoff = fn(buf, n, n_pad=n_pad)
            return len(emit_quantized(data, 0, n, elen[:n].numpy().copy(),
                                      eoff[:n].numpy().copy()))

        one = size(te._emit_inputs_device)
        ladder = size(te._emit_inputs_device_ladder)
        assert one <= ladder * 1.02, (one, ladder)


def test_ratio_vs_search_encoder():
    for payload in (b"lorem ipsum dolor sit amet " * 2000,
                    bytes(50000) + b"tail " * 400, _text(230_000)):
        emit = te.compress_block_device_emit(payload, device=CPU)
        search = te.compress_block_device(payload, device=CPU)
        assert len(emit) <= len(search) * 1.05


def test_emit_inputs_are_true_matches():
    """Every device decision (length, offset) is a real match: the host
    splice never verifies."""
    rng = np.random.default_rng(33)
    data = np.frombuffer(b"".join([
        b"periodic!" * 300, bytes(500),
        rng.integers(0, 8, 4000, dtype=np.uint8).tobytes()]), np.uint8)
    elen, eoff = te.emit_inputs(data, device=CPU)
    for p in np.flatnonzero(elen):
        L, d = int(elen[p]), int(eoff[p])
        assert d > 0 and p - d >= 0 and p + L <= data.size
        assert bytes(data[p - d:p - d + L]) == bytes(data[p:p + L])


def test_splice_merges_same_offset_runs():
    for payload in (bytes(992), bytes(1024), b"\xaa" * 100, b"ab" * 3000):
        emit = te.compress_block_device_emit(payload, device=CPU)
        search = te.compress_block_device(payload, device=CPU)
        assert decode_block(np.frombuffer(emit, np.uint8),
                            len(payload)) == payload
        assert len(emit) <= len(search)


def test_emit_history_matches():
    hist = b"shared dictionary content " * 100
    payload = b"shared dictionary content " * 50 + b"new tail"
    comp = te.compress_block_device_emit(payload, hist=hist, device=CPU)
    buf = np.zeros(len(hist) + len(payload) + 8, np.uint8)
    buf[:len(hist)] = np.frombuffer(hist, np.uint8)
    end = decode_block_ring_py(np.frombuffer(comp, np.uint8), buf,
                               len(hist), 0)
    assert bytes(buf[len(hist):end]) == payload
