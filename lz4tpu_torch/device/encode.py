"""Match finding on the device by sorting grams (port of
``lz4tpu.device.encode``).

The search, the costly part of LZ4 encoding, runs as tensor operations on
the device; the byte-granular emission (verify, extend, token stream)
stays on the host in the native engine.  The JAX package computes these
functions outside any kernel too (XLA, no Pallas), so their first form
here is PyTorch ops: sorts, rolls, gathers and scans.  On the card the
one-sort scheme's prefix levels are one hand-written kernel (H8,
``device/emit_levels.py``); :func:`_level_deltas` stays as its plain
version, which CPU tensors run.

1. grams: g(p) = the 4 bytes at p as one signed int32 word, read
   circularly over the padded buffer (words wrap as int32 does).
2. sort the grams, ties by position: equal grams become adjacent and
   ascend by position.
3. an entry's k-th sorted predecessor with the same gram is its k-th
   nearest earlier 4-byte occurrence: a depth-k hash chain with no
   collisions (the key is the gram itself).
4. the candidates go back to position order (a scatter through the sort's
   permutation, the same values as the JAX package's restore sort).

Three passes are built on this:

* :func:`match_candidates`: the depth-k chain, int32 positions;
* :func:`compact_candidates`: the default stream of ``backend="device"``,
  two uint16 deltas a byte (nearest same-4-gram and nearest same-8-gram
  predecessor), 4 B a payload byte to the host;
* :func:`emit_inputs`: every match decided on the device (one 9-key sort
  by the 32-byte prefix, segmented scans per prefix level, run
  combining), again 4 B a payload byte; the host only splices tokens
  (``backend="device-emit"``).  The scans are kernel H8 on the card.

``jax.lax.sort`` with several keys is lexicographic and the port's sort
is not: :func:`_sort_order` packs two int32 keys into one int64 that
orders as the pair of signed words, and sorts stably from the last key to
the first.  Position is always the last key and is unique, so the
permutation, and every output, is the JAX package's.

Each wrapper takes ``device=`` (``"cuda"`` by default, which raises where
CUDA is absent; ``"cpu"`` runs the same ops on the CPU).  Only the
finished candidate or decision arrays cross to the host.  The card's
times of each pass, split by stage, are in PERF.md ("device functions
outside Pallas", measured by ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..trace import count, span
from .emit_levels import emit_levels

K_CANDS_DEFAULT = 8     # depth of the legacy candidate chain
_SCAN_BLOCK = 512
_WINDOW = 65535         # the farthest an LZ4 match may reach back


def _pad(data: np.ndarray, device) -> tuple[torch.Tensor, int, int]:
    """``data`` zero-padded to a multiple of 1024 bytes, on ``device``
    (staged as the decoders stage their inputs); with ``n`` and ``n_pad``."""
    from . import to_device

    n = int(data.size)
    n_pad = (n + 1023) // 1024 * 1024
    buf = np.zeros(n_pad, np.uint8)
    buf[:n] = data
    return to_device(buf, device), n, n_pad


def _word(b: torch.Tensor, s: int) -> torch.Tensor:
    """The 4 bytes at p+s..p+s+3 (little endian, circular along the last
    axis) as one signed int32.  ``b`` is int64, so the sum is exact and
    is then brought into int32's range as the int32 sum wraps."""
    w = (torch.roll(b, -s, -1) + torch.roll(b, -s - 1, -1) * 256
         + torch.roll(b, -s - 2, -1) * 65536
         + torch.roll(b, -s - 3, -1) * 16777216)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _gram_words(b: torch.Tensor, n_words: int = 8) -> list:
    """Overlapping 4-byte words at offsets 0,4,..,4*(n_words-1)."""
    b = b.to(torch.int64)
    return [_word(b, s) for s in range(0, 4 * n_words, 4)]


def _sort_order(keys) -> torch.Tensor:
    """int64 permutation along the last axis that sorts positions by
    ``keys`` (int32, signed, the first most significant), ties by
    position: the order of ``jax.lax.sort((*keys, pos),
    num_keys=len(keys) + 1)``.  Two keys travel as one int64 whose high
    word is the first and whose low word is the second plus 2**31, so the
    pair orders as two signed words; the packed keys sort stably from the
    last to the first, starting from position order."""
    packed = []
    for i in range(0, len(keys), 2):
        if i + 1 < len(keys):
            packed.append(keys[i].to(torch.int64) * (1 << 32)
                          + (keys[i + 1].to(torch.int64) + (1 << 31)))
        else:
            packed.append(keys[i])
    order = None
    for k in reversed(packed):
        if order is not None:
            k = k.gather(-1, order)
        o = torch.sort(k, dim=-1, stable=True).indices
        order = o if order is None else order.gather(-1, o)
    return order


def _restore(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Values in sorted order back in position order (``out[order] =
    vals``: the restore sort's result, by a scatter)."""
    return torch.empty_like(vals).scatter_(-1, order, vals)


def _positions(n_pad: int, device) -> torch.Tensor:
    return torch.arange(n_pad, dtype=torch.int32, device=device)


def _candidates_device(buf: torch.Tensor, *, n_pad: int,
                       k_cands: int = 1) -> torch.Tensor:
    """int32[k_cands, n_pad]: per position the k nearest earlier
    positions with the same 4-gram within 64 KiB (-1: none)."""
    pos = _positions(n_pad, buf.device)
    g = _gram_words(buf, 1)[0]
    order = _sort_order([g])
    g_s = g.gather(-1, order)
    p_s = order.to(torch.int32)
    # within a same-gram run positions ascend, so the k-th previous
    # sorted entry with an equal gram is the k-th nearest earlier
    # occurrence
    out = []
    for k in range(1, k_cands + 1):
        c = torch.where((pos >= k) & (torch.roll(g_s, k, -1) == g_s),
                        torch.roll(p_s, k, -1), -1)
        c = _restore(order, c)
        out.append(torch.where(pos - c <= _WINDOW, c, -1))
    return torch.stack(out)


def match_candidates(data: np.ndarray, k_cands: int = 1, *,
                     device="cuda") -> np.ndarray:
    """int32[k_cands, n]: the k nearest previous same-4-gram positions
    per position (-1 = none within 64 KiB) — the depth-k hash chain,
    computed by gram sorting.  ``data`` may be history+block joined;
    positions are into that joined buffer."""
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    n = int(data.size)
    if n < 8:
        return np.full((k_cands, n), -1, np.int32)
    buf, n, n_pad = _pad(data, dev)
    cand = _candidates_device(buf, n_pad=n_pad,
                              k_cands=k_cands)[:, :n].cpu().numpy()
    # wrapped grams at the very end can produce bogus forward refs
    cand[:, max(0, n - 3):] = -1
    return cand


def _compact_grams(buf: torch.Tensor):
    """The 4-gram and the 8-gram's second word at every position."""
    g4 = _gram_words(buf, 1)[0]
    return g4, torch.roll(g4, -4, -1)


def _nearest_prev(order: torch.Tensor, keys, pos: torch.Tensor):
    """In sorted order: the previous entry's position where it has the
    same ``keys`` (-1 where not)."""
    same = pos >= 1
    for k in keys:
        k_s = k.gather(-1, order)
        same = same & (torch.roll(k_s, 1, -1) == k_s)
    p_s = order.to(torch.int32)
    return torch.where(same, torch.roll(p_s, 1, -1), -1)


def _delta(c: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    d = pos - c
    return torch.where((c >= 0) & (d <= _WINDOW), d, 0)


def _candidates_compact_device(buf: torch.Tensor, *,
                               n_pad: int) -> torch.Tensor:
    """Compact candidate stream: TWO uint16 offset deltas per position
    (4 B per payload byte), along the last axis of ``buf``
    (``(..., n_pad)`` uint8; leading axes are independent buffers).

    delta[0]: distance to the nearest previous same-4-GRAM position
      (guaranteed match >= 4 — the short-match candidate).
    delta[1]: distance to the nearest previous same-8-GRAM position
      (guaranteed match >= 8).  Because the 8-gram sort has zero
      collisions, this reaches long matches at ANY depth of the 4-gram
      chain.

    0 = no candidate within the 64 KiB window.  Result ``(..., 2,
    n_pad)`` uint16.
    """
    pos = _positions(n_pad, buf.device)
    g4, g8 = _compact_grams(buf)
    o4 = _sort_order([g4])
    c4 = _restore(o4, _nearest_prev(o4, [g4], pos))
    o8 = _sort_order([g4, g8])
    c8 = _restore(o8, _nearest_prev(o8, [g4, g8], pos))
    return torch.stack([_delta(c4, pos), _delta(c8, pos)],
                       dim=-2).to(torch.uint16)


def compact_candidates(data: np.ndarray, *, device="cuda") -> np.ndarray:
    """uint16[2, n] offset deltas per position (0 = none): nearest
    same-4-gram and nearest same-8-gram predecessors — the 4 B/byte
    candidate stream (see _candidates_compact_device)."""
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    n = int(data.size)
    if n < 8:
        return np.zeros((2, n), np.uint16)
    buf, n, n_pad = _pad(data, dev)
    d = _candidates_compact_device(buf, n_pad=n_pad)[:, :n].cpu().numpy()
    # wrapped grams at the end can fabricate matches into the padding
    d[0, max(0, n - 3):] = 0
    d[1, max(0, n - 7):] = 0
    return d


def deltas_to_positions(deltas: np.ndarray) -> np.ndarray:
    """uint16 delta stream -> int32 candidate positions for the native
    emitter (-1 = none).  Host-side, O(n) memory ops — the deltas are
    what crosses to the host."""
    n = deltas.shape[1]
    pos = np.arange(n, dtype=np.int32)
    d = deltas.astype(np.int32)
    return np.where(d > 0, pos[None, :] - d, -1).astype(np.int32)


# ---------------------------------------------------------------------------
# token decisions on the device (backend="device-emit")
# ---------------------------------------------------------------------------

def _emit_inputs_device_ladder(buf: torch.Tensor, n_real: int, *,
                               n_pad: int):
    """Per-level gram ladder (one multi-key sort + restore per level,
    EXACT nearest-previous occurrence).  Kept as the quality reference of
    :func:`_emit_inputs_device`'s one-sort scheme (differential size
    tests)."""
    g = _gram_words(buf)
    pos = _positions(n_pad, buf.device)

    def nearest(nwords):
        order = _sort_order(g[:nwords])
        cr = _restore(order, _nearest_prev(order, g[:nwords], pos))
        d = pos - cr
        ok = ((cr >= 0) & (d <= _WINDOW)
              & (pos + 4 * nwords <= n_real))   # gram reads real bytes only
        return torch.where(ok, d, 0)

    levels = [(4 * w, nearest(w)) for w in (1, 2, 4, 8)]
    return _combine_levels(levels, n_real, n_pad)


def _combine_levels(levels, n_real: int, n_pad: int):
    """Level selection + log-doubling run combining (shared tail of
    both emit-inputs schemes).  ``levels``: [(k_bytes, d_k)] ascending;
    the longest level with a candidate wins per position.  Rolls are
    circular, as ``jnp.roll``'s are, shifts beyond the length included."""
    dev = levels[0][1].device
    pos = _positions(n_pad, dev)
    L = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    d = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    for k, dk in levels:
        dk = dk.to(torch.int32)
        L = torch.where(dk > 0, k, L)
        d = torch.where(dk > 0, dk, d)
    for j in range(11):                     # 32 -> 65536
        step = 32 << j
        can = ((L == step) & (torch.roll(L, -step) == step)
               & (d == torch.roll(d, -step)) & (pos + 2 * step <= n_real))
        L = torch.where(can, 2 * step, L)
    L = torch.clamp(L, max=65535)
    return L.to(torch.uint16), d.to(torch.uint16)


def _pshift(y: torch.Tensor, s: int, fill) -> torch.Tensor:
    """Shift right by ``s`` along the last axis, filling with ``fill``
    (the doubling-step primitive of the blocked scans below)."""
    pad = torch.full(y.shape[:-1] + (s,), fill, dtype=y.dtype,
                     device=y.device)
    return torch.cat([pad, y[..., :-s]], dim=-1)


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor via a two-level blocked
    Hillis-Steele: log2(block) doubling steps on an (n/block, block) view
    plus a carry scan over block totals."""
    n = x.shape[0]
    blk = _SCAN_BLOCK if n % _SCAN_BLOCK == 0 else 1
    if blk == 1 or n <= blk:
        return torch.cumsum(x, 0, dtype=x.dtype)
    y = x.reshape(n // blk, blk)
    s = 1
    while s < blk:
        y = y + _pshift(y, s, 0)
        s <<= 1
    tot = y[:, -1]
    s = 1
    while s < tot.shape[0]:
        tot = tot + _pshift(tot, s, 0)
        s <<= 1
    carry = _pshift(tot, 1, 0)
    return (y + carry[:, None]).reshape(-1)


def _seg_min_prefix(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Inclusive SEGMENTED prefix-min: out[i] = min(v[s_i..i]) where
    s_i is the latest j <= i with f[j] (f[0] must be True).  Blocked
    two-level segmented Hillis-Steele with the classic pair operator
    (flag ORs forward; the value stops combining once a boundary is
    inside the right span)."""
    big = torch.iinfo(v.dtype).max
    n = v.shape[0]
    blk = _SCAN_BLOCK if n % _SCAN_BLOCK == 0 and n > _SCAN_BLOCK else n
    vv = v.reshape(n // blk, blk)
    ff = f.reshape(n // blk, blk)
    s = 1
    while s < blk:
        vp = _pshift(vv, s, big)
        fp = _pshift(ff, s, False)
        vv = torch.where(ff, vv, torch.minimum(vv, vp))
        ff = ff | fp
        s <<= 1
    if blk != n:
        av, af = vv[:, -1], ff[:, -1]
        s = 1
        while s < av.shape[0]:
            avp = _pshift(av, s, big)
            afp = _pshift(af, s, False)
            av = torch.where(af, av, torch.minimum(av, avp))
            af = af | afp
            s <<= 1
        carry = _pshift(av, 1, big)
        vv = torch.where(ff, vv, torch.minimum(vv, carry[:, None]))
    return vv.reshape(-1)


def _seg_min_suffix(v: torch.Tensor, bnd: torch.Tensor) -> torch.Tensor:
    """Segmented suffix-min: out[i] = min(v[i..e_i]) where e_i is the
    last index before the NEXT boundary (bnd[j] starts a group at j).
    Implemented as the reversed prefix scan with the boundary flags
    shifted to mark segment-LAST positions."""
    last = torch.roll(bnd, -1)
    last[-1] = True
    return _seg_min_prefix(v.flip(0), last.flip(0)).flip(0)


def _level_deltas(ws, p_s: torch.Tensor) -> dict:
    """The scans of the one-sort scheme: per prefix level k (4..32 bytes)
    the distance back to the best candidate of each sorted entry (0:
    none), in sorted order.  ``ws`` are the gram words and ``p_s`` the
    positions, both in sorted order.

    A level's candidates are its group's minimum position (exact
    segmented prefix + suffix minima, on the four main levels 4, 8, 16
    and 32) and the sort-order neighbours at +-{1,2,4,8,16} that lie in
    the same group (no group start between them: one blocked prefix sum
    of the boundary flags per level).  The largest valid candidate within
    64 KiB wins.  ``idx`` is the index in sorted order, as in the JAX
    package: the masks read it, not the position."""
    n_pad = p_s.shape[0]
    idx = _positions(n_pad, p_s.device)
    agree = idx >= 1
    agree_at = {}
    for j, w in enumerate(ws):
        agree = agree & (torch.roll(w, 1) == w)
        agree_at[4 * (j + 1)] = agree

    def consider(best, c, valid):
        valid = valid & (c < p_s) & (p_s - c <= _WINDOW)
        return torch.where(valid & (c > best), c, best)

    dlev = {}
    for k, agree_k in agree_at.items():
        bnd = ~agree_k                       # group starts here
        cnt = _blocked_cumsum(bnd.to(torch.int32))
        if k in (4, 8, 16, 32):
            gmin = torch.minimum(_seg_min_prefix(p_s, bnd),
                                 _seg_min_suffix(p_s, bnd))
        else:
            gmin = p_s                       # self: always invalid below
        best = torch.full((n_pad,), -1, dtype=torch.int32,
                          device=p_s.device)
        best = consider(best, gmin, torch.ones_like(bnd))
        for r in (1, 2, 4, 8, 16):
            best = consider(best, torch.roll(p_s, r),
                            (idx >= r) & (cnt == torch.roll(cnt, r)))
            best = consider(best, torch.roll(p_s, -r),
                            (idx < n_pad - r) & (cnt == torch.roll(cnt, -r)))
        dlev[k] = torch.where(best >= 0, p_s - best, 0)
    return dlev


def _emit_inputs_device(buf: torch.Tensor, n_real: int, *, n_pad: int):
    """Per-position match decisions, entirely on the device: emit_len
    uint16 (0 = literal byte) and offset uint16 — 4 B per payload byte.

    ONE content sort by the full 32-byte prefix (8 gram words +
    position, 9 keys) orders every level at once: positions sharing a
    k-byte prefix are contiguous in that order for all k <= 32, so a
    level's previous-occurrence candidate is a segmented scan, not a
    sort (:func:`_level_deltas`).  One restore carries all eight levels
    back to position order; a level counts where its bytes are real data
    (pos + k <= n_real), and :func:`_combine_levels` picks the longest
    level and merges equal runs.  A chosen candidate c < pos shares k
    real bytes with pos, so decisions are byte-equal matches by
    construction.

    On a CUDA buffer the levels are one launch of kernel H8
    (:func:`.emit_levels.emit_levels`, counted once a block as
    ``encode.levels.kernel``); on a CPU one :func:`_level_deltas`, its
    plain version.  Spans ``encode.grams``, ``encode.sort``,
    ``encode.levels``, ``encode.restore`` and ``encode.combine``: the
    host's time to issue each stage's operations (and any wait inside
    them)."""
    with span("encode.grams"):
        g = _gram_words(buf)
    with span("encode.sort"):
        order = _sort_order(g)
    with span("encode.levels"):
        p_s = order.to(torch.int32)
        if buf.is_cuda:
            dlev = emit_levels(buf, p_s)
            count("encode.levels.kernel", 1)
        else:
            dlev = _level_deltas([w.gather(-1, order) for w in g], p_s)
    with span("encode.restore"):
        pos = _positions(n_pad, buf.device)
        lev = [(k, torch.where(pos + k <= n_real, _restore(order, dk), 0))
               for k, dk in sorted(dlev.items())]
    with span("encode.combine"):
        return _combine_levels(lev, n_real, n_pad)


def emit_inputs(data: np.ndarray, *, device="cuda"):
    """(emit_len uint16[n], offset uint16[n]) from the device one-sort
    scheme + run combining (all end-of-buffer masking on the device).

    Spans ``encode.issue`` (the device pass's operations handed to the
    device) and ``encode.fetch`` (the decisions' copy to the host, which
    waits for the device)."""
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    n = int(data.size)
    if n < 16:
        return np.zeros(n, np.uint16), np.zeros(n, np.uint16)
    buf, n, n_pad = _pad(data, dev)
    with span("encode.issue"):
        elen, eoff = _emit_inputs_device(buf, n, n_pad=n_pad)
    with span("encode.fetch"):
        return elen[:n].cpu().numpy(), eoff[:n].cpu().numpy()


def _joined(src, hist) -> tuple[np.ndarray, int, int]:
    src_b = bytes(src)
    hist_b = bytes(hist[-65536:]) if hist else b""
    return (np.frombuffer(hist_b + src_b, np.uint8), len(hist_b),
            len(src_b))


def compress_block_device_emit(src, hist: bytes = b"", *,
                               device="cuda") -> bytes:
    """LZ4 block via device emission: all match SEARCH on the device
    (:func:`_emit_inputs_device`); the host performs only the linear
    token walk + byte splice (native ``emit_quantized`` — no searching,
    no byte comparisons, no length extension).  Round-trips bit-exactly;
    the ratio is quantized-length greedy."""
    from .. import native
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    joined, hist_len, src_len = _joined(src, hist)
    if not src_len:
        return b""
    elen, eoff = emit_inputs(joined, device=dev)
    with span("encode.splice"):
        return native.emit_quantized(joined, hist_len, src_len, elen, eoff)


def compress_block_device(
    src, hist: bytes = b"", lazy: bool = True,
    k_cands: int | None = None, *, device="cuda",
) -> bytes:
    """LZ4 block compression with device-side match finding.

    Default (``k_cands=None``): the compact 2-candidate stream
    (nearest-4-gram + nearest-8-gram, 4 B shipped per payload byte);
    the native emitter verifies, extends and emits the token stream,
    keeping the longest candidate (with one-step lazy deferral like
    the host hash-chain encoder).  An explicit ``k_cands`` selects the
    depth-k chain (32 B/byte at k=8; kept for the depth-ratio tests).
    Round-trips bit-exactly either way.
    """
    from .. import native
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    joined, hist_len, src_len = _joined(src, hist)
    if not src_len:
        return b""
    if k_cands is None:
        cand = deltas_to_positions(compact_candidates(joined, device=dev))
    else:
        cand = match_candidates(joined, k_cands, device=dev)
    return native.compress_block_cands(joined, hist_len, src_len, cand,
                                       lazy=lazy)
