"""mxu2 engine: per-byte routing codes from the host packer (port of
``lz4tpu.device.mxu2``), for text chains that overflow the fused
engine's in-substep patch budget.

The packer resolves every output byte's provenance on the host
(``DensePack2``: one int32 code per byte), natively or, where the
native engine is absent, in numpy (:func:`_pack_chain`).  The device
side is kernel H3 (``csrc/mxu2.cu``): :func:`_route` resolves every
byte of every chain at once, each ring reference turned into the absolute position
of the byte it reads (:func:`sources_plain`) and the links followed by
pointer jumping (:func:`jump_plain`).  :func:`route_plain`, the serial
substep loop through the 64 KiB ring, is the spec and the version a
CPU tensor takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels
from . import to_device, to_device_packed
from .ring import RING, part_segments, segments_array, zero_ring

SUB = 2048          # output bytes per substep
PAGES = 256         # 64 KiB history ring: 256 pages x 256 bytes
ROWB = 256          # bytes per ring row
PART_SUBS = 32768   # substeps per launch (64 MiB output, 256 MiB codes)
_KIND_RING = 1 << 16


@dataclasses.dataclass
class DensePack2:
    """Per-byte routing codes for one or more chains; the fields of
    ``lz4tpu.device.mxu2.DensePack2``.

    code[i, j] describes output byte j of substep i:
      bit 16 set   -> ring byte: bits 0..15 = source position mod 64 Ki
      bit 16 clear -> known value: bits 17..24 = the byte
    """

    code: np.ndarray       # int32 [n_sub, SUB]
    scal: np.ndarray       # int32 [n_sub, 1]: ring row to write (mult of 8)
    n_sub: int
    out_spans: list        # [(chain_id, sub_lo, sub_hi, out_len)]


def pack_from_numpy(pack) -> DensePack2:
    """The port's DensePack2 from a ``lz4tpu.device.mxu2.DensePack2``."""
    return DensePack2(code=np.array(pack.code), scal=np.array(pack.scal),
                      n_sub=pack.n_sub, out_spans=list(pack.out_spans))


def _pack_chain(
    ll: np.ndarray, ls: np.ndarray, ml: np.ndarray, mo: np.ndarray,
    buf: np.ndarray,
) -> tuple[np.ndarray, int]:
    """Resolve one chain's per-byte provenance in numpy (a copy of
    ``lz4tpu.device.mxu2._pack_chain``; the native resolver's
    reference); returns (code, n_out)."""
    sizes = (ll + ml).astype(np.int64)
    n_out = int(sizes.sum())
    if n_out == 0:
        return np.zeros((0,), np.int32), 0
    starts = np.zeros(sizes.size, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    seq = np.repeat(np.arange(sizes.size, dtype=np.int64), sizes)
    j = np.arange(n_out, dtype=np.int64)
    local = j - starts[seq]
    is_lit = local < ll[seq]
    # literal byte values straight from the compressed buffer
    litpos = np.where(is_lit, ls[seq].astype(np.int64) + local, 0)
    litval = buf[litpos].astype(np.int32)
    # match source: byte m of a match copies from (j - off), always
    src = j - mo[seq]
    sub_base = j & ~np.int64(SUB - 1)

    # One resolve hop: fixed points are literals and bytes whose source
    # lies before their substep; everything else steps to its source
    # (same substep, since src >= sub_base and src < j).
    fixed = is_lit | (src < sub_base)
    h = np.where(fixed, j, src)
    # Pointer doubling: chains are intra-substep, <= SUB-1 hops.
    k = 1
    while k < SUB:
        h = h[h]
        k <<= 1
    a = h
    code = np.where(
        is_lit[a],
        litval[a] << 17,
        (src[a] & 0xFFFF).astype(np.int64) | _KIND_RING,
    ).astype(np.int32)
    return code, n_out


def pack_dense2(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    chain_ranges: list | None = None,
) -> DensePack2:
    """Pack sequence-table ranges (one per independent chain) into
    per-byte routing codes (JAX-free copy of
    ``lz4tpu.device.mxu2.pack_dense2``): the native resolver when the
    engine is there, :func:`_pack_chain` in numpy otherwise, with equal
    codes."""
    from .. import native

    if chain_ranges is None:
        chain_ranges = [(0, lit_len.size)]
    ll = np.ascontiguousarray(lit_len, np.int32)
    ls = np.ascontiguousarray(lit_src, np.int32)
    ml = np.ascontiguousarray(match_len, np.int32)
    mo = np.ascontiguousarray(match_off, np.int32)
    use_native = native.available()
    sizes64 = ll.astype(np.int64) + ml
    chain_outs = [int(sizes64[lo:hi].sum()) for lo, hi in chain_ranges]
    chain_subs = [-(-n // SUB) if n else 0 for n in chain_outs]
    total_subs = sum(chain_subs)
    if total_subs == 0:
        return DensePack2(
            code=np.zeros((0, SUB), np.int32),
            scal=np.zeros((0, 1), np.int32),
            n_sub=0,
            out_spans=[(c, 0, 0, 0) for c in range(len(chain_ranges))],
        )
    # one padded (n_sub, SUB) array; the resolver wild-writes up to 16
    # words past a chain's end and re-zeroes them
    flat = np.zeros(total_subs * SUB + 16, np.int32)
    scal = np.empty((total_subs, 1), np.int32)
    out_spans = []
    sub_base = 0
    for c, (lo, hi) in enumerate(chain_ranges):
        n_out = chain_outs[c]
        if n_out == 0:
            out_spans.append((c, sub_base, sub_base, 0))
            continue
        dst = flat[sub_base * SUB:]
        if use_native:
            native.pack_dense2_chain(
                buf, ll[lo:hi], ls[lo:hi], ml[lo:hi], mo[lo:hi], out=dst)
        else:
            dst[:n_out] = _pack_chain(
                ll[lo:hi], ls[lo:hi], ml[lo:hi], mo[lo:hi], buf)[0]
        n_sub_c = chain_subs[c]
        scal[sub_base:sub_base + n_sub_c, 0] = (
            (np.arange(n_sub_c, dtype=np.int32) * (SUB // ROWB))
            & (PAGES - 1)
        )
        out_spans.append((c, sub_base, sub_base + n_sub_c, n_out))
        sub_base += n_sub_c
    return DensePack2(
        code=flat[:total_subs * SUB].reshape(total_subs, SUB),
        scal=scal, n_sub=total_subs, out_spans=out_spans,
    )


def passes_for(n: int) -> int:
    """Pointer-jumping passes that resolve any pack of ``n`` substeps:
    every link of a chain goes to an earlier substep of its segment, so
    a chain has fewer than ``n`` links, and ``ceil(log2(n)) + 1`` passes
    of doubling cover them (16 for ``PART_SUBS``)."""
    return max(n - 1, 0).bit_length() + 1


def _route(code: torch.Tensor, scal: torch.Tensor, segs: torch.Tensor,
           ring_in: torch.Tensor | None = None):
    """Decode every segment ``segs[k] = (lo, hi, carry)`` of substeps
    through its ring; returns ``(rows, ring_out)``: uint8 ``(n_sub *
    SUB,)`` and the last segment's final ``(65536,)`` ring.  Segments
    are disjoint and in substep order (``ring.part_segments``); rows of
    a substep in no segment are 0.

    On a CUDA tensor, kernel H3 resolves every byte at once: it takes
    the ring rows of a segment to advance 8 a substep (``scal[i + 1] ==
    (scal[i] + 8) & 255``, multiples of 8), as ``pack_dense2`` makes
    them, and decodes other rows wrongly.  Checking that would wait for
    the card, so this wrapper does not and is private: the entry that
    launches it, :func:`decode_dense2_rows`, checks the rows on the host
    before it stages them and raises ``ValueError`` on any other
    pattern.  One call is one memset, ``passes_for(n) + 2`` kernels and
    4 B of scratch a byte.  On a CPU tensor: :func:`route_plain`, which
    takes any rows."""
    if code.device.type == "cpu":
        return route_plain(code, scal, segs, ring_in)
    n = code.shape[0]
    dev = code.device
    _kernels.check(code, "code", torch.int32, (n, SUB))
    _kernels.check(scal, "scal", torch.int32, (n, 1), align=4)
    _kernels.check(segs, "segs", torch.int32, (segs.shape[0], 3), align=4)
    if ring_in is not None:
        _kernels.check(ring_in, "ring_in", torch.uint8, (RING,))
    rows = torch.empty(n * SUB, dtype=torch.uint8, device=dev)
    ring_out = torch.empty(RING, dtype=torch.uint8, device=dev)
    passes = passes_for(n)
    # state words, the passes' flags
    scratch = torch.empty(n * SUB + passes + 1, dtype=torch.int32,
                          device=dev)
    _kernels.launch(
        "mxu2_route", "lz4t_mxu2_route", dev,
        code.data_ptr(), scal.data_ptr(), segs.data_ptr(), segs.shape[0],
        _kernels.ptr(ring_in), rows.data_ptr(), ring_out.data_ptr(), n,
        passes, scratch.data_ptr())
    return rows, ring_out


def route_plain(code: torch.Tensor, scal: torch.Tensor, segs: torch.Tensor,
                ring_in: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`_route`: a serial substep loop."""
    dev = code.device
    n = code.shape[0]
    rows = torch.zeros(n * SUB, dtype=torch.uint8, device=dev)
    is_ring = ((code >> 16) & 1).bool()
    src = (code & 0xFFFF).to(torch.int64)
    known = ((code >> 17) & 255).to(torch.uint8)
    ring_rows = scal[:, 0].tolist()
    ring = zero_ring(dev)
    for lo, hi, carry in segs.tolist():
        ring = (ring_in.clone() if carry and ring_in is not None
                else zero_ring(dev))
        for i in range(lo, hi):
            vals = torch.where(is_ring[i], ring[src[i]], known[i])
            rows[i * SUB:(i + 1) * SUB] = vals
            r = (ring_rows[i] & 255) * ROWB
            ring[r:r + SUB] = vals
    return rows, ring


def sources_plain(code: torch.Tensor, scal: torch.Tensor,
                  segs: torch.Tensor,
                  ring_in: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel H3's first pass: each code as a state
    word, int32 ``(n_sub * SUB,)``: ``>= 0`` the absolute position
    (substep * SUB + byte) of the byte it equals, ``< 0`` the resolved
    byte ``~s``.  A ring reference at offset ``o`` in substep ``i``
    names the byte that substep ``i - 1 - ((blk_i - o // SUB - 1) mod
    32)`` wrote there (``blk_i = (scal[i] & 255) // 8``), or, before the
    segment, the initial ring's byte (``ring_in`` where the segment
    carries, else 0)."""
    dev = code.device
    n = code.shape[0]
    state = torch.full((n, SUB), -1, dtype=torch.int32, device=dev)
    blocks = RING // SUB
    offs = code & 0xFFFF
    blk = (scal[:, :1] & 255) >> 3
    i = torch.arange(n, dtype=torch.int32, device=dev).unsqueeze(1)
    k = i - 1 - ((blk - (offs >> 11) - 1) & (blocks - 1))
    for lo, hi, carry in segs.tolist():
        part = slice(lo, hi)
        init = (ring_in if carry and ring_in is not None
                else zero_ring(dev)).to(torch.int32)
        ring_ref = ((code[part] >> 16) & 1).bool()
        known = ~((code[part] >> 17) & 255)
        back = k[part] >= lo
        pointer = k[part] * SUB + (offs[part] & (SUB - 1))
        before = ~init[offs[part].to(torch.int64)]
        state[part] = torch.where(ring_ref,
                                  torch.where(back, pointer, before), known)
    return state.reshape(-1)


def jump_plain(state: torch.Tensor, passes: int) -> torch.Tensor:
    """Plain version of kernel H3's pointer jumping: ``passes`` rounds
    of ``s = state[s]`` for every pointer (``s >= 0``), all at once."""
    for _ in range(passes):
        ptr = state >= 0
        if not bool(ptr.any()):
            break
        state = torch.where(ptr, state[state.clamp(min=0).to(torch.int64)],
                            state)
    return state


def route_jump_plain(code: torch.Tensor, scal: torch.Tensor,
                     segs: torch.Tensor,
                     ring_in: torch.Tensor | None = None):
    """Kernel H3's three steps in plain PyTorch: :func:`sources_plain`,
    :func:`jump_plain` for ``passes_for(n)`` passes, then the bytes and
    ``ring_out`` (the last segment's last 32 substeps, below them its
    initial ring).  Equals :func:`route_plain` on rows that advance 8 a
    substep."""
    dev = code.device
    n = code.shape[0]
    state = jump_plain(sources_plain(code, scal, segs, ring_in),
                       passes_for(n))
    if bool((state >= 0).any()):
        raise RuntimeError("mxu2: pointers left after every pass")
    rows = (~state).to(torch.uint8)
    ring = zero_ring(dev)
    seg_rows = segs.tolist()
    if seg_rows:
        lo, hi, carry = seg_rows[-1]
        if carry and ring_in is not None:
            ring = ring_in.clone()
        o = torch.arange(RING, dtype=torch.int64, device=dev)
        last = (int(scal[hi - 1, 0]) & 255) >> 3
        k = hi - 1 - ((last - (o >> 11)) & (RING // SUB - 1))
        mine = k >= lo
        ring[mine] = rows[k[mine] * SUB + (o[mine] & (SUB - 1))]
    return rows, ring


def check_ring_rows(scal: np.ndarray, out_spans) -> None:
    """Raise ``ValueError`` unless every chain's ring rows advance 8 a
    substep from a multiple of 8 (``pack_dense2``'s pattern, which kernel
    H3 takes for granted)."""
    rows = np.asarray(scal).reshape(-1).astype(np.int64) & (PAGES - 1)
    step = SUB // ROWB
    ok = bool((rows % step == 0).all())
    for (_c, lo, hi, _n) in out_spans:
        ok = ok and bool((((rows[lo + 1:hi] - rows[lo:hi - 1]) & (PAGES - 1))
                          == step).all())
    if not ok:
        raise ValueError(
            "mxu2 pack: ring rows must advance 8 a substep within a chain")


def decode_dense2_rows(pack: DensePack2, device, ring_in=None,
                       part_subs: int | None = None):
    """Decode a DensePack2 on ``device``; returns ``(rows, ring_out)``:
    flat uint8 rows ``(n_sub * SUB,)`` (chain ``k``'s bytes at
    ``out_spans[k]``) and the final ring.  Packs beyond ``part_subs``
    substeps launch part by part, each part's ring seeding the next;
    ``ring_in`` seeds the first chain's ring.  Raises ``ValueError`` if
    a chain's ring rows do not advance 8 a substep
    (:func:`check_ring_rows`)."""
    dev = torch.device(device)
    n = pack.n_sub
    if n == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                zero_ring(dev) if ring_in is None else ring_in)
    check_ring_rows(pack.scal[:n], pack.out_spans)
    part = part_subs or PART_SUBS
    bounds = [(p0, min(p0 + part, n)) for p0 in range(0, n, part)]
    # the small tables share one staging copy
    scal, *part_segs = to_device_packed(
        [pack.scal[:n]]
        + [segments_array(part_segments(pack.out_spans, p0, p1,
                                        seeded=ring_in is not None))
           for p0, p1 in bounds], dev)
    ring = ring_in
    parts = []
    for (p0, p1), segs in zip(bounds, part_segs):
        rows, ring = _route(to_device(pack.code[p0:p1], dev), scal[p0:p1],
                            segs, ring)
        parts.append(rows)
    return (parts[0] if len(parts) == 1 else torch.cat(parts)), ring


def decode_dense2(pack: DensePack2, device="cuda") -> list:
    """Decode a DensePack2 on ``device`` (``"cuda"`` by default; it
    raises without CUDA, ``"cpu"`` takes the plain version); returns
    ``[(chain_id, bytes)]`` as ``lz4tpu.device.mxu2.decode_dense2``
    does."""
    from ..pipeline import _resolve_device

    rows, _ring = decode_dense2_rows(pack, _resolve_device(device))
    flat = rows.cpu().numpy()
    return [(c, flat[slo * SUB: slo * SUB + out_len].tobytes())
            for (c, slo, _shi, out_len) in pack.out_spans]
