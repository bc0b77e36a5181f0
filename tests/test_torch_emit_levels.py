"""Kernel H8's tiled scheme, as its numpy model, against the encoder's
plain prefix levels (``encode._level_deltas``) on the CPU.

:func:`golden_levels` runs the kernel's three passes (per tile lcp and
tile functions, their carry across tiles, the segmented minima and
neighbour tests within a tile) with the tile size as a parameter;
small tiles put many tile edges inside every group and every neighbour
window.  Tolerance 0.  The kernel itself is held against the plain
version on the card (``tests/test_torch_kernels.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import lz4tpu_torch
from lz4tpu_torch import _kernels, trace
from lz4tpu_torch.device import emit_levels as el
from lz4tpu_torch.device import encode as te

SRC = pathlib.Path(lz4tpu_torch.__file__).resolve().parent

_MAIN = (4, 8, 16, 32)  # levels whose group minimum is a candidate
_RADII = (1, 2, 4, 8, 16)
_WINDOW = 65535
_BIG = 2**31 - 1


def _then(f, g):
    """The tile functions ``x -> r ? a : min(a, x)``: g after f."""
    (fa, fr), (ga, gr) = f, g
    return np.where(gr, ga, np.minimum(fa, ga)), fr | gr


def golden_levels(buf: np.ndarray, p_s: np.ndarray, tile: int) -> dict:
    """numpy model of H8 with tiles of ``tile`` entries: ``{k: int32
    [n_pad]}`` as ``emit_levels.emit_levels`` returns.  ``buf`` uint8
    and ``p_s`` int32 (positions in sorted order), both of length
    n_pad."""
    n = p_s.size
    n_t = -(-n // tile)
    p = np.full(n_t * tile, _BIG, np.int64)     # past the end: each entry
    p[:n] = p_s                                 # its own group, never seen

    # pass 1: lcp from the 32 bytes at each position, read circularly
    words = buf[(p[:n, None] + np.arange(32)) % n].view("<u4")
    lcp = np.zeros(n_t * tile + 1, np.int64)
    lcp[1:n] = np.cumprod(words[1:] == words[:-1], axis=1).sum(axis=1)
    P = p.reshape(n_t, tile)
    carry_l, carry_r = {}, {}
    starts, ends = {}, {}
    for k in _MAIN:
        starts[k] = (lcp[:-1] < k // 4).reshape(n_t, tile)
        ends[k] = (lcp[1:] < k // 4).reshape(n_t, tile)
        fwd = (np.full(n_t, _BIG), np.zeros(n_t, bool))
        bwd = fwd
        for c in range(tile):
            fwd = _then(fwd, (P[:, c], starts[k][:, c]))
            bwd = _then(bwd, (P[:, tile - 1 - c], ends[k][:, tile - 1 - c]))
        # pass 2: each tile's carry from the left and from the right
        cl = np.full(n_t, _BIG)
        cr = np.full(n_t, _BIG)
        for b in range(1, n_t):
            cl[b] = fwd[0][b - 1] if fwd[1][b - 1] else min(fwd[0][b - 1],
                                                            cl[b - 1])
            e = n_t - 1 - b
            cr[e] = bwd[0][e + 1] if bwd[1][e + 1] else min(bwd[0][e + 1],
                                                            cr[e + 1])
        carry_l[k], carry_r[k] = cl, cr

    # pass 3: within each tile, the group minima from the carries
    gmin = {}
    for k in _MAIN:
        pre = np.empty_like(P)
        suf = np.empty_like(P)
        x, y = carry_l[k].copy(), carry_r[k].copy()
        for c in range(tile):
            x = np.where(starts[k][:, c], P[:, c], np.minimum(x, P[:, c]))
            pre[:, c] = x
            d = tile - 1 - c
            y = np.where(ends[k][:, d], P[:, d], np.minimum(y, P[:, d]))
            suf[:, d] = y
        gmin[k] = np.minimum(pre, suf).reshape(-1)[:n]
    # and the neighbours: the least lcp over (i - r, i] and (i, i + r],
    # with lcp 0 past either end (a halo of 16 entries a side)
    halo = max(_RADII)
    lh = np.concatenate([np.zeros(halo, np.int64), lcp[:n],
                         np.zeros(halo + 1, np.int64)])
    ph = np.concatenate([np.full(halo, _BIG), p[:n], np.full(halo, _BIG)])
    i = np.arange(n) + halo
    pos = p[:n]
    out = {}
    for k in el.LEVELS:
        best = np.full(n, -1, np.int64)

        def consider(c, ok):
            nonlocal best
            ok = ok & (c < pos) & (pos - c <= _WINDOW) & (c > best)
            best = np.where(ok, c, best)

        if k in _MAIN:
            consider(gmin[k], True)
        for r in _RADII:
            back = np.min([lh[i - s] for s in range(r)], axis=0)
            fwd = np.min([lh[i + 1 + s] for s in range(r)], axis=0)
            consider(ph[i - r], back >= k // 4)
            consider(ph[i + r], fwd >= k // 4)
        out[k] = np.where(best >= 0, pos - best, 0).astype(np.int32)
    return out


def _text(n: int) -> bytes:
    blob = b"".join(p.read_bytes() for p in sorted(SRC.glob("*.py")))
    return (blob * (n // len(blob) + 1))[:n]


def _words(n: int) -> bytes:
    toks = sorted(set(re.findall(
        rb"[A-Za-z_][A-Za-z0-9_]*|[^A-Za-z0-9_\s]+|\s+", _text(100_000))))
    rng = np.random.default_rng(7)
    return b"".join(toks[i] for i in rng.integers(0, len(toks), n))[:n]


def _frag(n: int) -> bytes:
    rng = np.random.default_rng(11)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(512)]
    return b"".join(frags[i] for i in rng.integers(0, 512, n // 3 + 8))[:n]


def _rand(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _runs() -> bytes:
    """Random bytes with runs of three byte values: groups of a few
    entries, of about 70 and of about 570 (one, two and many tiles of 64
    and 256 entries), at every level."""
    d = _rand(8192, 3)
    d[100:140] = 1
    d[1000:1100] = 2
    d[3000:3600] = 3
    return d.tobytes()


def _window() -> bytes:
    """Two 16-byte patterns repeated exactly 65,535 and 65,536 bytes
    later: the first pair is in the window, the second just outside."""
    d = _rand(66_560, 5)
    for at, pat in ((100, b"IN-WINDOW-EDGE!!"), (300, b"OUT-OF-WINDOW!!!")):
        a = np.frombuffer(pat, np.uint8)
        gap = 65_535 if at == 100 else 65_536
        d[at:at + 16] = a
        d[at + gap:at + gap + 16] = a
    return d.tobytes()


CASES = {
    "words": lambda: _words(8192),
    "zeros": lambda: bytes(8192),          # one group over every tile
    "urandom": lambda: _rand(8192, 1).tobytes(),
    "frag": lambda: _frag(8192),
    "runs": _runs,
    "window": _window,
    "n1024": lambda: _text(1000),          # one tile, part of one
    "n5k": lambda: _words(5 * 1024),       # not a multiple of the tile
    "shuffled": None,                      # text in a random order
}


def _inputs(case: str):
    """The padded buffer, the positions in sorted order and the gram words
    in that order, as ``_emit_inputs_device`` makes them."""
    data = np.frombuffer(CASES[case]() if CASES[case] else _text(4096),
                         np.uint8)
    n_pad = (data.size + 1023) // 1024 * 1024
    buf = np.zeros(n_pad, np.uint8)
    buf[:data.size] = data
    g = te._gram_words(torch.from_numpy(buf))
    if case == "shuffled":
        order = torch.from_numpy(np.random.default_rng(2).permutation(n_pad))
    else:
        order = te._sort_order(g)
    return buf, order.to(torch.int32), [w.gather(-1, order) for w in g]


@pytest.mark.parametrize("tile", [64, 256, el.TILE])
@pytest.mark.parametrize("case", sorted(CASES))
def test_golden_tiles_equal_the_plain_levels(case, tile):
    buf, p_s, ws = _inputs(case)
    want = te._level_deltas(ws, p_s)
    got = golden_levels(buf, p_s.numpy(), tile)
    assert sorted(got) == sorted(want) == list(el.LEVELS)
    for k in el.LEVELS:
        assert got[k].dtype == np.int32
        assert np.array_equal(got[k], want[k].numpy()), k
    if case == "window":       # the edge is reached and not passed
        assert (got[16] == 65_535).any()
        assert got[16].max() == 65_535


@pytest.mark.parametrize("n_pad,why", [(1024, "CUDA tensor"),
                                        (1000, "multiple of 1024"),
                                        (0, "multiple of 1024")])
def test_kernel_wrapper_refuses_what_it_does_not_take(n_pad, why):
    buf = torch.zeros(n_pad, dtype=torch.uint8)
    p_s = torch.arange(n_pad, dtype=torch.int32)
    with pytest.raises(ValueError, match=why):
        el.emit_levels(buf, p_s)
    assert _kernels.LAUNCHES["emit_levels"] == 0


def test_cpu_encoder_takes_the_plain_levels(monkeypatch):
    """A CPU buffer goes through ``_level_deltas``: the kernel does not
    run, and its counter stays 0."""
    def refuse(*_a, **_k):
        raise AssertionError("the kernel on a CPU buffer")

    monkeypatch.setattr(te, "emit_levels", refuse)
    calls = []
    real = te._level_deltas
    monkeypatch.setattr(te, "_level_deltas",
                        lambda *a: calls.append(1) or real(*a))
    blob = _words(3000)
    with trace.recording() as rec:
        frame = lz4tpu_torch.compress(blob, backend="device-emit",
                                      device="cpu")
    assert lz4tpu_torch.decompress(frame) == blob
    assert calls == [1]
    assert "encode.levels.kernel" not in rec.counters
