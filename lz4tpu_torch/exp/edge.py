"""Hand-made inputs at the edges of kernel H6 (``segment_decode``), of
kernel H1's route, of H3's passes, of H7's ring and of H9's codes, each
with a reference of its own (numpy, the host packer, or the kernel's
plain version).

The CPU tests run them through the plain versions, the tests on the
card and ``chip_smoke.py`` through the kernels: the same tables, the
same expected bytes.  Everything is made from fixed seeds.

Segment cases put sequences where H6's design has an edge: its output
tiles (``TILE`` bytes), its shared-memory ring (at most 128 KiB) and
LZ4's largest offset (65,535).  Route cases put a thread's four sources
where a gather has one: across a 4-byte word, across a run's end, and
across the ring's end into the literal window.
"""

from __future__ import annotations

import numpy as np

TILE = 8192            # output bytes per step of kernel H6
RING_MAX = 1 << 17     # its largest ring
SUB = 2048
RING = 65536
WIN = 4096


# ---------------------------------------------------------------------------
# segment_decode
# ---------------------------------------------------------------------------

def _table(spec, seed, tail_gap=0):
    """``spec``: (gap, lit_len, match_off, match_len) per sequence, the
    gap being output bytes left unwritten before it.  Returns ``(comp,
    (dst, lit_src, lit_len, match_off, match_len), n_out)``; literal
    bytes are seeded and lie in ``comp`` with a few unused bytes between
    runs."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((5, len(spec)), np.int64)
    cur = src = 0
    for i, (gap, ll, off, ml) in enumerate(spec):
        cur += gap
        src += i % 3
        cols[:, i] = (cur, src, ll, off, ml)
        src += ll
        cur += ll + ml
    comp = rng.integers(1, 256, src + 8, dtype=np.uint8)
    return comp, tuple(c.astype(np.int32) for c in cols), cur + tail_gap


def ref_segment(comp, cols, n_out) -> np.ndarray:
    """What a sequence table decodes to, sequence by sequence in numpy."""
    out = np.zeros(n_out, np.uint8)
    for d, ls, ll, off, ml in zip(*(c.tolist() for c in cols)):
        out[d:d + ll] = comp[ls:ls + ll]
        if ml:
            md = d + ll
            out[md:md + ml] = np.resize(out[md - max(off, 1):md], ml)
    return out


def _ring_far():
    """300,000 bytes, longer than the largest ring: offset 65,535 again
    and again, sources that reach back across a tile edge, matches that
    span several tiles."""
    rng = np.random.default_rng(101)
    spec = [(0, 70_000, 0, 0), (0, 0, 65_535, 100)]
    cur, k = 70_100, 0
    while cur < 300_000:
        ll = int(rng.integers(0, 7))
        md = cur + ll
        if k % 50 == 0:
            off, ml = 65_535, int(rng.integers(4, 60))
        elif k % 97 == 0:
            off = int(rng.integers(1, 65_536))
            ml = int(rng.integers(300, 20_000))      # may overlap itself
        elif k % 31 == 0:
            # the source straddles the last tile edge before md
            edge = md // TILE * TILE
            ml = int(rng.integers(8, 33))
            off = min(md, md - edge + ml // 2)
        else:
            off = int(rng.integers(1, min(md, 65_535) + 1))
            ml = int(rng.integers(4, 41))
        spec.append((0, ll, off, ml))
        cur = md + ml
        k += 1
    return _table(spec, 1)


def _gaps():
    """Unwritten bytes between sequences, across tile edges too, matches
    that read them (as zeros), and an unwritten tail."""
    rng = np.random.default_rng(102)
    spec, cur = [(3, 40, 0, 0)], 43
    while cur < 40_000:
        gap = int(rng.integers(0, 21)) if rng.integers(0, 3) == 0 else 0
        to_edge = TILE - (cur % TILE)
        if to_edge <= 12:
            gap = to_edge + 9               # the gap lies across the edge
        ll = int(rng.integers(0, 9))
        md = cur + gap + ll
        off = int(rng.integers(1, md + 1))
        ml = int(rng.integers(0, 30))
        spec.append((gap, ll, off, ml))
        cur = md + ml
    return _table(spec, 2, tail_gap=100)


def _overlap(off):
    """An overlapping match (offset 1, 2 or 3) that starts 10 bytes
    before a tile edge and spans three tiles."""
    return _table([(0, TILE - 10, 0, 0), (0, 0, off, 20_000),
                   (0, 5, 0, 0)], 10 + off)


def _off_far():
    """Match offsets above 65,535 (no LZ4 encoder emits them, the table
    format admits them): sources older than any ring, read back from
    device memory; and one literal run across many tiles."""
    rng = np.random.default_rng(104)
    spec = [(0, 150_000, 0, 0)]
    cur, k = 150_000, 0
    while cur < 400_000:
        ll = int(rng.integers(0, 5))
        md = cur + ll
        if k % 3 == 0:
            off = int(rng.integers(65_536, md + 1))
        elif k % 3 == 1:
            off = int(rng.integers(RING_MAX - 2 * TILE, RING_MAX + TILE))
        else:
            off = int(rng.integers(1, 65_536))
        ml = int(rng.integers(4, 41)) if k % 40 else int(
            rng.integers(1000, 12_000))
        spec.append((0, ll, off, ml))
        cur = md + ml
        k += 1
    return _table(spec, 4)


SEGMENT_CASES = {
    "ring_far": _ring_far,
    "gaps": _gaps,
    "overlap1": lambda: _overlap(1),
    "overlap2": lambda: _overlap(2),
    "overlap3": lambda: _overlap(3),
    "off_far": _off_far,
}


def segment_case(name):
    """``(comp, cols, n_out, want)`` of one named case."""
    comp, cols, n_out = SEGMENT_CASES[name]()
    return comp, cols, n_out, ref_segment(comp, cols, n_out)


# ---------------------------------------------------------------------------
# fused route
# ---------------------------------------------------------------------------

def route_case(n_sub: int = 40, seed: int = 7, stray: bool = False):
    """A made-up route input: ``(pos17, lits, winq, scal)`` as numpy
    arrays of the kernel's shapes.  Each substep's 2048 sources are runs
    of consecutive addresses, 1 to 12 long, that start anywhere: most
    threads' four bytes cross a 4-byte word or a run's end, and some
    runs go over the ring's end into the window (65535 then 65536), sit
    at the window's last byte or at ring byte 0.  Ring rows advance by
    8 a substep as the prep's do, so the ring wraps; ``scal[:, 6]`` is
    the prep's window-reload flag (substep 0 and every change of
    window).  ``stray`` puts sources outside the 17-bit space into
    every substep, below 0 and past the window's end (no prep makes
    them; the route clamps them to ring byte 0 and to the window's last
    byte)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_sub, SUB), np.int32)
    for i in range(n_sub):
        row, j = pos[i], 0
        while j < SUB:
            n = min(int(rng.integers(1, 13)), SUB - j)
            kind = int(rng.integers(0, 8))
            if kind == 0:                       # over the ring's end
                start = RING - int(rng.integers(1, n + 1))
            elif kind == 1:                     # up to the window's end
                start = RING + WIN - n
            elif kind == 2:                     # from ring byte 0
                start = 0
            elif kind <= 4:                     # inside the window
                start = RING + int(rng.integers(0, WIN - n + 1))
            else:
                start = int(rng.integers(0, RING - n + 1))
            row[j:j + n] = start + np.arange(n)
            j += n
        if stray:
            at = rng.choice(SUB, 16, replace=False)
            row[at] = np.resize([-1, -RING - 5, RING + WIN, 1 << 18], 16)
    n_win = 3
    lits = rng.integers(0, 256, (n_win, 32, 256), dtype=np.uint8)
    winq = rng.integers(0, n_win, n_sub).astype(np.int32)
    scal = np.zeros((n_sub, 8), np.int32)
    scal[:, 0] = (5 + 8 * np.arange(n_sub)) % 256
    scal[:, 0] = np.minimum(scal[:, 0], 248)    # a row's 2 KiB stays inside
    scal[:, 1] = rng.integers(0, 17, n_sub)
    scal[0, 6] = 1
    scal[1:, 6] = (winq[1:] != winq[:-1]) | (scal[1:, 1] != scal[:-1, 1])
    return pos, lits, winq, scal


def ref_route(pos17, lits, winq, scal, segs, ring_in=None):
    """The route in numpy: ``(rows, ring)`` after the last segment."""
    n = pos17.shape[0]
    rows = np.zeros(n * SUB, np.uint8)
    flat = lits.reshape(lits.shape[0], -1)
    ring = np.zeros(RING, np.uint8)
    for lo, hi, carry in segs:
        ring = (ring_in.copy() if carry and ring_in is not None
                else np.zeros(RING, np.uint8))
        for i in range(lo, hi):
            win = flat[winq[i], scal[i, 1] * 256: scal[i, 1] * 256 + WIN]
            p = pos17[i].astype(np.int64)
            vals = np.where(p >= RING, win[np.clip(p - RING, 0, WIN - 1)],
                            ring[np.clip(p, 0, RING - 1)])
            rows[i * SUB:(i + 1) * SUB] = vals
            r = (scal[i, 0] & 255) * 256
            ring[r:r + SUB] = vals
    return rows, ring


# ---------------------------------------------------------------------------
# mxu2 route
# ---------------------------------------------------------------------------

def deep_chain(n_sub: int, seed: int = 3):
    """A made-up mxu2 pack ``(code, scal)`` whose reference chains are as
    deep as its substeps allow: substep 0 holds known bytes, and each byte
    of a later substep reads the same byte of the substep before it
    through the ring, but for one known byte in 64 (never in column 0).
    So byte 0 of the last substep lies ``n_sub - 1`` links from a known
    byte: the depth that kernel H3's ``passes_for(n_sub)`` passes must
    cover.  Ring rows advance 8 a substep from 0, as ``pack_dense2``'s."""
    rng = np.random.default_rng(seed)
    code = rng.integers(0, 256, (n_sub, SUB)).astype(np.int32) << 17
    prev = (np.arange(n_sub - 1)[:, None] * SUB + np.arange(SUB)) % RING
    fresh = rng.random((n_sub - 1, SUB)) < 1 / 64
    fresh[:, 0] = False
    code[1:] = np.where(fresh, code[1:], (1 << 16) | prev)
    scal = ((np.arange(n_sub) * (SUB // 256)) & 255).astype(np.int32)
    return code, scal.reshape(-1, 1)


# ---------------------------------------------------------------------------
# the A/B harness's route (kernel H7)
# ---------------------------------------------------------------------------

def ab_codes(n_sub: int, sub: int, seed: int = 5) -> np.ndarray:
    """Made-up H7 codes ``(n_sub, sub)`` int32 that no packer makes: in
    every substep, the first included, three codes in four are ring codes
    at any offset and the rest known bytes.  So the first substeps read
    ``ring_in`` (or zeros) wherever the stream has not yet written, every
    later one reads bytes written at every distance, and ``ring_out``
    keeps bytes of ``ring_in`` when the stream is shorter than the ring."""
    rng = np.random.default_rng(seed)
    known = rng.integers(0, 256, (n_sub, sub)).astype(np.int32) << 17
    ring = rng.integers(0, RING, (n_sub, sub)).astype(np.int32) | 1 << 16
    return np.where(rng.random((n_sub, sub)) < 0.75, ring, known)


# ---------------------------------------------------------------------------
# dense_codes (H9)
# ---------------------------------------------------------------------------

def dense_table(chains, seed=0):
    """Sequence-table columns of chains given as ``[(lit_len, match_len,
    match_off)]`` each, laid end to end as a table lays them (global
    ``out_start`` and ``lit_src``) over seeded literal bytes: ``(cols,
    buf, ranges)``, ``cols = (out_start, lit_len, lit_src, match_len,
    match_off)`` int32, ``ranges`` each chain's sequences."""
    seqs = [s for c in chains for s in c]
    ll, ml, mo = (np.array(v, np.int32) for v in zip(*seqs))
    ls = np.zeros_like(ll)
    ls[1:] = np.cumsum(ll)[:-1]
    out_start = np.zeros_like(ll)
    out_start[1:] = np.cumsum(ll.astype(np.int64) + ml)[:-1]
    buf = np.random.default_rng(seed).integers(0, 256, int(ll.sum()) + 8,
                                               dtype=np.uint8)
    bounds = np.cumsum([0] + [len(c) for c in chains]).tolist()
    return ((out_start, ll, ls, ml, mo), buf,
            list(zip(bounds[:-1], bounds[1:])))


#: H9's edges, as ``dense_table`` arguments: where its fill, its
#: pointer doubling, its chunks of 512 sequences and the ring codes have
#: one.  ``before-chain`` is the host packer's status 2: the second
#: chain's first match reaches into the first chain.
DENSE_CASES = {
    # off == 1 runs: within a substep, across substep edges, after a
    # literal that ends a substep
    "off1": ([[(1, 9_000, 1), (2_047, 4, 1), (1, 2_049, 1), (0, 3, 1),
               (5, 0, 0)]], 0),
    # 1 < off < 2048: overlaps whose sources cross a substep edge
    "overlap": ([[(1_000, 3_000, 700), (3, 5_000, 1_500),
                  (10, 2_047, 2_047), (0, 4_100, 2), (4, 0, 0)]], 0),
    # off >= 2048: ring codes that wrap the 64 Ki ring, and a match
    # longer than the ring
    "ring": ([[(70_000, 0, 0), (3, 100, 3_000), (0, 10_000, 60_000),
               (5, 2_500, 65_535), (1, 150_000, 2_048), (7, 40, 65_535)]],
             1),
    # chains that end mid-substep, an empty one, several with their
    # out_spans and ring rows
    "chains": ([[(100, 1_000, 60), (7, 0, 0)], [(5, 0, 0)],
                [(3_000, 4, 2_100), (1, 7_000, 3)], [(1, 2_046, 1)]], 2),
    # more than 512 sequences in one substep (4-byte matches), so that
    # the kernel takes a second chunk
    "chunks": ([[(2, 4, 1)] + [(0, 4, 1)] * 1500 + [(2, 0, 0)]], 4),
    "before-chain": ([[(50, 10, 5)], [(4, 8, 30)]], 3),
}


def dense_case(name):
    """``(cols, buf, ranges)`` of ``DENSE_CASES[name]``."""
    chains, seed = DENSE_CASES[name]
    return dense_table(chains, seed)
