"""mxu2 engine: per-byte routing codes (port of ``lz4tpu.device.mxu2``),
for text chains that overflow the fused engine's in-substep patch
budget.

Every output byte has one int32 code (``DensePack2``).  For a decode on
the card, kernel H9 (``csrc/dense_codes.cu``) builds them there from the
dense chains' sequence columns and the compressed buffer
(:func:`dense_codes`; :func:`dense_codes_plain` is its plain version);
the plan records only what they are built from (:func:`defer_dense2`).
For a decode on the CPU, the host packer builds them (:func:`pack_dense2`:
natively or, where the native engine is absent, in numpy,
:func:`_pack_chain`), with equal codes.  The decode is kernel H3
(``csrc/mxu2.cu``): :func:`_route` resolves every byte of every chain at
once, each ring reference turned into the absolute position of the byte
it reads (:func:`sources_plain`) and the links followed by pointer
jumping (:func:`jump_plain`).  :func:`route_plain`, the serial substep
loop through the 64 KiB ring, is the spec and the version a CPU tensor
takes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _kernels, trace
from . import to_device, to_device_packed, to_device_rows
from .ring import RING, part_segments, segments_array, zero_ring

SUB = 2048          # output bytes per substep
PAGES = 256         # 64 KiB history ring: 256 pages x 256 bytes
ROWB = 256          # bytes per ring row
PART_SUBS = 32768   # substeps per launch (64 MiB output, 256 MiB codes)
_KIND_RING = 1 << 16
_CHAIN_ROW = 5      # H9's chain table: sub_lo, seq_lo, seq_hi, out_lo, n_out


@dataclasses.dataclass
class DensePack2:
    """Per-byte routing codes for one or more chains; the fields of
    ``lz4tpu.device.mxu2.DensePack2``.

    code[i, j] describes output byte j of substep i:
      bit 16 set   -> ring byte: bits 0..15 = source position mod 64 Ki
      bit 16 clear -> known value: bits 17..24 = the byte

    In the deferred form (:func:`defer_dense2`) ``code`` is None and the
    pack holds what the codes are built from: ``cols``, the sequence
    table's columns ``(out_start, lit_len, lit_src, match_len,
    match_off)``, ``buf``, the compressed buffer, and ``chain_ranges``,
    each chain's sequence range, one per entry of ``out_spans``.
    """

    code: np.ndarray | None   # int32 [n_sub, SUB]
    scal: np.ndarray       # int32 [n_sub, 1]: ring row to write (mult of 8)
    n_sub: int
    out_spans: list        # [(chain_id, sub_lo, sub_hi, out_len)]
    cols: tuple | None = None
    buf: np.ndarray | None = None
    chain_ranges: list | None = None

    def packed(self) -> DensePack2:
        """This pack with its codes on the host: itself, or the deferred
        form packed by :func:`pack_dense2` (the same layout)."""
        if self.code is not None:
            return self
        _out_start, ll, ls, ml, mo = self.cols
        return pack_dense2(ll, ml, mo, ls, self.buf,
                           chain_ranges=self.chain_ranges)


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


def _layout(chain_outs: list) -> tuple:
    """``(scal, out_spans)`` of chains of ``chain_outs`` bytes laid end
    to end, each from a fresh substep: ring rows advance 8 a substep from
    0 in each chain; a chain with no bytes takes no substep."""
    scal, out_spans, sub_base = [], [], 0
    for c, n_out in enumerate(chain_outs):
        n_sub_c = -(-n_out // SUB)
        scal.append((np.arange(n_sub_c, dtype=np.int32) * (SUB // ROWB))
                    & (PAGES - 1))
        out_spans.append((c, sub_base, sub_base + n_sub_c, n_out))
        sub_base += n_sub_c
    return (np.concatenate(scal or [np.zeros(0, np.int32)])
            .astype(np.int32).reshape(-1, 1), out_spans)


def pack_dense2(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    chain_ranges: list | None = None,
) -> DensePack2:
    """Pack sequence-table ranges (one per independent chain) into
    per-byte routing codes on the host (JAX-free copy of
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
    scal, out_spans = _layout([int(sizes64[lo:hi].sum())
                               for lo, hi in chain_ranges])
    total_subs = scal.shape[0]
    # one padded (n_sub, SUB) array; the resolver wild-writes up to 16
    # words past a chain's end and re-zeroes them
    flat = np.zeros(total_subs * SUB + 16, np.int32)
    for (lo, hi), (_c, sub_lo, _sub_hi, n_out) in zip(chain_ranges,
                                                      out_spans):
        if n_out == 0:
            continue
        dst = flat[sub_lo * SUB:]
        if use_native:
            native.pack_dense2_chain(
                buf, ll[lo:hi], ls[lo:hi], ml[lo:hi], mo[lo:hi], out=dst)
        else:
            dst[:n_out] = _pack_chain(
                ll[lo:hi], ls[lo:hi], ml[lo:hi], mo[lo:hi], buf)[0]
    return DensePack2(
        code=flat[:total_subs * SUB].reshape(total_subs, SUB),
        scal=scal, n_sub=total_subs, out_spans=out_spans,
    )


def defer_dense2(
    out_start: np.ndarray,
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    chain_ranges: list,
) -> DensePack2:
    """The deferred form of :func:`pack_dense2` on the same ranges: the
    same ``scal``, ``n_sub`` and ``out_spans``, no codes.  A chain's
    bytes come from ``out_start`` (each sequence's output offset, as the
    sequence table holds it), so this costs a few reads a chain; the
    decode builds the codes where it runs (:func:`decode_dense2_rows`)."""
    outs = [int(out_start[hi - 1]) + int(lit_len[hi - 1])
            + int(match_len[hi - 1]) - int(out_start[lo]) if hi > lo else 0
            for lo, hi in chain_ranges]
    scal, out_spans = _layout(outs)
    return DensePack2(
        code=None, scal=scal, n_sub=scal.shape[0], out_spans=out_spans,
        cols=(out_start, lit_len, lit_src, match_len, match_off), buf=buf,
        chain_ranges=list(chain_ranges))


def _code_tables(pack: DensePack2) -> tuple:
    """``(ranges, chains)`` of a deferred pack for kernel H9: the
    sequence ranges of its chains that have bytes, in pack order (the
    columns to stage, end to end), and H9's chain table, int32
    ``(k, 5)``: a row ``(sub_lo, seq_lo, seq_hi, out_lo, n_out)`` a
    chain, its sequences ``[seq_lo, seq_hi)`` of the staged columns and
    ``out_lo`` its first sequence's ``out_start``."""
    out_start = pack.cols[0]
    ranges, rows, base = [], [], 0
    for (lo, hi), (_c, sub_lo, _sub_hi, n_out) in zip(pack.chain_ranges,
                                                      pack.out_spans):
        if n_out:
            ranges.append((lo, hi))
            rows.append((sub_lo, base, base + hi - lo, int(out_start[lo]),
                         n_out))
            base += hi - lo
    return ranges, np.array(rows, np.int32).reshape(-1, _CHAIN_ROW)


def stage_dense_codes(pack: DensePack2, device,
                      comp_dev: torch.Tensor | None = None) -> tuple:
    """What H9 reads for a deferred pack, on ``device``: ``(cols, chains,
    comp, flag)``; ``cols`` the five columns of the pack's chains, int32
    ``(5, n_seq)``, in one staging copy; ``chains`` and a zeroed int32
    ``flag`` in another; ``comp`` the compressed buffer (``comp_dev``
    where the caller staged it)."""
    dev = torch.device(device)
    ranges, chains = _code_tables(pack)
    cols = to_device_rows(pack.cols, ranges, dev)
    chains, flag = to_device_packed([chains, np.zeros(1, np.int32)], dev)
    comp = comp_dev if comp_dev is not None else to_device(pack.buf, dev)
    return cols, chains, comp, flag


def stage_dense2(pack: DensePack2 | None, device,
                 comp_dev: torch.Tensor | None = None) -> tuple | None:
    """What :func:`decode_dense2_rows` stages for ``pack`` on ``device``
    before its launches, for a caller that stages every input before it
    launches anything: H9's inputs (:func:`stage_dense_codes`, span
    ``decode.dense.codes``) where the card builds the codes, a deferred
    pack on a CUDA device; None where the host packer builds them."""
    if (pack is None or pack.code is not None or not pack.n_sub
            or torch.device(device).type != "cuda"):
        return None
    with trace.span("decode.dense.codes"):
        return stage_dense_codes(pack, device, comp_dev)


def dense_codes(cols: torch.Tensor, chains: torch.Tensor,
                comp: torch.Tensor, flag: torch.Tensor, p0: int,
                n: int) -> torch.Tensor:
    """Codes of substeps ``[p0, p0 + n)`` of a pack, int32 ``(n, SUB)``,
    from :func:`stage_dense_codes`'s tensors: those the host packer
    writes, 0 past a chain's end.

    On a CUDA tensor, kernel H9, one block a substep, on the current
    stream; a match that reaches before its chain's start stores the host
    packer's status 2 in ``flag``, which :func:`raise_on_fault` turns
    into its ``ValueError`` once the caller reads it.  On a CPU tensor:
    :func:`dense_codes_plain`, which raises at once."""
    if cols.device.type == "cpu":
        return dense_codes_plain(cols, chains, comp, p0, n)
    dev = cols.device
    _kernels.check(cols, "cols", torch.int32, (5, cols.shape[1]), align=4)
    _kernels.check(chains, "chains", torch.int32,
                   (chains.shape[0], _CHAIN_ROW), align=4)
    _kernels.check(comp, "comp", torch.uint8, (comp.shape[0],), align=1)
    _kernels.check(flag, "flag", torch.int32, (1,), align=4)
    code = torch.empty((n, SUB), dtype=torch.int32, device=dev)
    _kernels.launch(
        "dense_codes", "lz4t_dense_codes", dev, cols.data_ptr(),
        cols.shape[1], chains.data_ptr(), chains.shape[0], comp.data_ptr(),
        p0, n, code.data_ptr(), flag.data_ptr())
    return code


def raise_on_fault(*flags: torch.Tensor) -> None:
    """Raise the host packer's ``ValueError`` if H9 stored a status in
    any of ``flags`` (reading one waits for the launches before it)."""
    for flag in flags:
        status = int(flag.item())
        if status:
            raise ValueError(f"pack_dense2 failed with status {status}")


def dense_codes_plain(cols: torch.Tensor, chains: torch.Tensor,
                      comp: torch.Tensor, p0: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of kernel H9 (:func:`dense_codes`), chain by
    chain as :func:`_pack_chain` resolves one: each byte's sequence by a
    search of the chain's output offsets, literals from ``comp``, ring
    codes for sources before the byte's substep, and in-substep sources
    followed by pointer doubling.  Raises the host packer's
    ``ValueError`` on a match that reaches before its chain's start."""
    dev = cols.device
    code = torch.zeros(n * SUB, dtype=torch.int32, device=dev)
    out_start, ll, ls, ml, mo = cols.to(torch.int64)
    for sub_lo, seq_lo, seq_hi, out_lo, n_out in chains.tolist():
        lo = max(sub_lo, p0)
        hi = min(sub_lo - (-n_out // SUB), p0 + n)
        if hi <= lo:
            continue
        j = torch.arange((lo - sub_lo) * SUB,
                         min((hi - sub_lo) * SUB, n_out), device=dev)
        rel = out_start[seq_lo:seq_hi] - out_lo
        s = seq_lo + torch.searchsorted(rel, j, right=True) - 1
        local = j - out_start[s] + out_lo
        is_lit = local < ll[s]
        litval = comp[torch.where(is_lit, ls[s] + local, 0)].to(
            torch.int64) << 17
        off = mo[s].clamp(min=1)
        src = j - off
        if bool((~is_lit & (src < 0)).any()):
            raise ValueError("pack_dense2 failed with status 2")
        idx = torch.arange(j.numel(), device=dev)
        h = torch.where(is_lit | (src < (j & ~(SUB - 1))), idx, idx - off)
        k = 1
        while k < SUB:
            h = h[h]
            k <<= 1
        at = (lo - p0) * SUB
        code[at:at + j.numel()] = torch.where(
            is_lit[h], litval[h], (src[h] & 0xFFFF) | _KIND_RING).to(
                torch.int32)
    return code.reshape(n, SUB)


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
                       part_subs: int | None = None, *,
                       comp_dev: torch.Tensor | None = None,
                       staged: tuple | None = None,
                       faults: list | None = None):
    """Decode a DensePack2 on ``device``; returns ``(rows, ring_out)``:
    flat uint8 rows ``(n_sub * SUB,)`` (chain ``k``'s bytes at
    ``out_spans[k]``) and the final ring.  Packs beyond ``part_subs``
    substeps launch part by part, each part's ring seeding the next;
    ``ring_in`` seeds the first chain's ring.  Raises ``ValueError`` if
    a chain's ring rows do not advance 8 a substep
    (:func:`check_ring_rows`).

    Where the codes come from follows the device the answer goes to.  A
    deferred pack decoded on a CUDA device stages its chains' columns
    once (``staged``: :func:`stage_dense2`'s tensors, where the caller
    staged them; ``comp_dev``: the compressed buffer, where the caller
    staged that) and builds each part's codes with kernel H9 just before
    that part's H3: no code crosses from the host, and the device holds
    one part's codes at a time (span ``decode.dense.codes``; counter
    ``decode.dense.device_codes``, the substeps whose codes the card
    built).  A match that reaches before its chain's start stores H9's
    fault flag: with ``faults``, the flag is appended to it for the
    caller to read with :func:`raise_on_fault` where it synchronises;
    without, it is read here, after the launches, and raises the host
    packer's ``ValueError``.  On the CPU, or with host codes, the codes
    are the host packer's (:meth:`DensePack2.packed`), which raises at
    once."""
    dev = torch.device(device)
    n = pack.n_sub
    if n == 0:
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                zero_ring(dev) if ring_in is None else ring_in)
    check_ring_rows(pack.scal[:n], pack.out_spans)
    on_card = pack.code is None and dev.type == "cuda"
    host = None if on_card else pack.packed()
    part = part_subs or PART_SUBS
    bounds = [(p0, min(p0 + part, n)) for p0 in range(0, n, part)]
    # the small tables share one staging copy
    scal, *part_segs = to_device_packed(
        [pack.scal[:n]]
        + [segments_array(part_segments(pack.out_spans, p0, p1,
                                        seeded=ring_in is not None))
           for p0, p1 in bounds], dev)
    if on_card and staged is None:
        staged = stage_dense2(pack, dev, comp_dev)
    ring = ring_in
    parts = []
    for (p0, p1), segs in zip(bounds, part_segs):
        if on_card:
            with trace.span("decode.dense.codes"):
                code = dense_codes(*staged, p0, p1 - p0)
        else:
            code = to_device(host.code[p0:p1], dev)
        rows, ring = _route(code, scal[p0:p1], segs, ring)
        parts.append(rows)
    if on_card:
        trace.count("decode.dense.device_codes", n)
        if faults is None:
            raise_on_fault(staged[3])
        else:
            faults.append(staged[3])
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
