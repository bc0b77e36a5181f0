"""Segment-copy chain decoder (port of ``lz4tpu.device.pallas_decode``).

LZ4 decode *is* a list of contiguous copies: per sequence one literal
copy from the compressed buffer and one match copy from the output's
own recent bytes.  Kernel H6 (``csrc/segment.cu``) walks each chain's
sequences in order, one chain per thread block, the chain's last 64 KiB
and the tile being built in a shared-memory ring: seven warps bring
literals in, expand the matches into a per-byte offset map and store
finished tiles, while one warp resolves the matches from that map, a
lane a byte; :func:`segment_decode_plain` is its plain PyTorch version,
taken only for CPU tensors.

The JAX package's kernel keeps compressed and decoded bytes as int32
word rows with a +512 B coordinate shift and slack rows, and caps a
chain at 6 MiB to fit the TPU's VMEM; none of that is carried.  Here
both live in device memory as bytes, and a chain is bounded only by the
sequence table's int32 coordinates.

A "chain" is a run of output the format makes sequential (a frame, or
an independent block).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from . import to_device


#: Ring sizes of kernel H6 (bytes of shared memory a block takes).
RING_SIZES = (1 << 16, 1 << 17)


def ring_bytes_for(max_chain: int | None) -> int:
    """The kernel's ring for a launch whose longest chain decodes to
    ``max_chain`` bytes: 64 KiB where that holds every chain whole (an
    LZ4 block of 64 KiB: two such blocks share an SM), and 128 KiB (64
    KiB of history beside the tiles in flight) for a longer or unknown
    one.  The smaller ring must hold its whole chain."""
    if max_chain is not None:
        for size in RING_SIZES:
            if max_chain <= size:
                return size
    return RING_SIZES[-1]


def segment_decode(comp: torch.Tensor, seqs: torch.Tensor,
                   chains: torch.Tensor, n_out: int,
                   zero_fill: bool = True,
                   max_chain: int | None = None) -> torch.Tensor:
    """Decode every chain of a sequence table: uint8 ``(n_out,)``.

    ``seqs``: int32 ``(5, S)`` rows dst, lit_src, lit_len, match_off,
    match_len, with ``dst`` chain-local and ``lit_src`` relative to the
    chain's compressed base.  ``chains``: int32 ``(C, 4)`` rows
    ``(seq_lo, seq_hi, comp_base, out_base)``.  Per sequence
    ``out[base + dst : +lit_len] = comp[cbase + lit_src : +lit_len]``,
    then the match ``out[md + i] = out[md - off + (i mod off)]`` with
    ``md = base + dst + lit_len``.  Bytes no sequence writes are 0;
    a caller whose sequences write every byte (:func:`covers`) passes
    ``zero_fill=False`` and saves the pass that clears the output.
    ``max_chain`` is the longest chain's decoded size as
    :func:`pack_chains` returns it with the tables: it lets a launch of
    short chains take the small ring (:func:`ring_bytes_for`).  A
    caller that packs its own tables leaves it ``None``; a number below
    the longest chain would let the ring overwrite history that a match
    still reads.
    The table must be in range and in output order
    (:func:`pack_chains` checks)."""
    if comp.device.type == "cpu":
        return segment_decode_plain(comp, seqs, chains, n_out)
    dev = comp.device
    s, c = seqs.shape[1], chains.shape[0]
    _kernels.check(comp, "comp", torch.uint8, (comp.shape[0],), align=1)
    _kernels.check(seqs, "seqs", torch.int32, (5, s), align=4)
    _kernels.check(chains, "chains", torch.int32, (c, 4), align=4)
    if c == 0 or s == 0:
        return torch.zeros(n_out, dtype=torch.uint8, device=dev)
    make = torch.zeros if zero_fill else torch.empty
    out = make(n_out, dtype=torch.uint8, device=dev)
    _kernels.launch(
        "segment_decode", "lz4t_segment_decode", dev,
        comp.data_ptr(), seqs.data_ptr(), s, chains.data_ptr(), c,
        out.data_ptr(), ring_bytes_for(max_chain))
    return out


def segment_decode_plain(comp: torch.Tensor, seqs: torch.Tensor,
                         chains: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_decode`: a serial loop
    over the sequences, one slice copy per literal run and per match."""
    out = torch.zeros(n_out, dtype=torch.uint8, device=comp.device)
    rows = seqs.tolist()
    for seq_lo, seq_hi, cbase, obase in chains.tolist():
        for i in range(seq_lo, seq_hi):
            d, ls, ll, off, ml = (r[i] for r in rows)
            d += obase
            if ll:
                out[d:d + ll] = comp[cbase + ls:cbase + ls + ll]
            if ml:
                md = d + ll
                off = max(off, 1)
                if off >= ml:
                    out[md:md + ml] = out[md - off:md - off + ml].clone()
                else:
                    k = torch.arange(ml, device=comp.device) % off
                    out[md:md + ml] = out[md - off + k]
    return out


def _check_chain(k: int, cols, n_seqs: int, comp_base: int, out_base: int,
                 n_loc: int, comp_size: int) -> None:
    dst, lit_src, lit_len, match_off, match_len = (
        np.asarray(c, np.int64) for c in cols)
    if not all(c.shape == (n_seqs,) for c in (dst, lit_src, lit_len,
                                              match_off, match_len)):
        raise ValueError(f"chain {k}: columns must each hold {n_seqs} "
                         "sequences")
    if n_seqs == 0:
        return
    md = dst + lit_len
    has_match = match_len > 0
    bad = (
        (lit_len < 0).any() or (match_len < 0).any() or (dst < 0).any()
        or (md + match_len > n_loc).any()
        or (lit_src < 0).any()
        or (comp_base + lit_src + lit_len > comp_size).any()
        or (has_match & (np.maximum(match_off, 1) > md)).any()
        or comp_base < 0 or out_base < 0
    )
    if bad:
        raise ValueError(f"chain {k}: sequence table out of range")
    # the kernel builds the output tile by tile: a sequence starts at or
    # after the end of the one before it (gaps are allowed and read 0)
    if (dst[1:] < (md + match_len)[:-1]).any():
        raise ValueError(f"chain {k}: sequences must be in output order "
                         "without overlap")


def covers(cols: list, rows: list) -> bool:
    """Whether the sequences write every output byte: the chains lie
    end to end from 0 and each chain's sequences follow one another
    without a gap up to its length (what an LZ4 sequence table does)."""
    end = 0
    for (dst, _src, lit_len, _off, match_len), (n_seqs, _c, obase, n_loc) \
            in sorted(zip(cols, rows), key=lambda cr: cr[1][2]):
        if obase != end:
            return False
        end += n_loc
        if n_seqs == 0:
            if n_loc:
                return False
            continue
        dst = np.asarray(dst, np.int64)
        stop = dst + lit_len + match_len
        if (dst[0] != 0 or stop[-1] != n_loc
                or not np.array_equal(dst[1:], stop[:-1])):
            return False
    return True


def pack_chains(cols: list, rows: list, comp_size: int, device):
    """The kernel's tables for several chains.  ``cols[k]``: chain
    ``k``'s five int32 numpy columns (dst chain-local, lit_src relative
    to ``comp_base``, lit_len, match_off, match_len); ``rows[k] =
    (n_seqs, comp_base, out_base, n_out)``.  Returns ``(seqs, chains,
    total, max_chain)`` for :func:`segment_decode`, ``max_chain`` being
    the largest ``n_out``.  Raises ``ValueError`` when a
    copy would leave the buffers, or when a chain's sequences are not
    in output order (an LZ4 table always is; gaps between sequences are
    admitted and decode to 0, match offsets beyond 65,535 are admitted
    too)."""
    total = max((base + n for _s, _c, base, n in rows), default=0)
    table, seq_lo = [], 0
    for k, (chain_cols, (n_seqs, cbase, obase, n_loc)) in enumerate(
            zip(cols, rows)):
        _check_chain(k, chain_cols, n_seqs, cbase, obase, n_loc, comp_size)
        table.append((seq_lo, seq_lo + n_seqs, cbase, obase))
        seq_lo += n_seqs
    seqs = np.empty((5, seq_lo), np.int32)
    for j in range(5):
        seqs[j] = np.concatenate([np.asarray(c[j], np.int32) for c in cols]
                                 or [np.zeros(0, np.int32)])
    chains = torch.tensor(table, dtype=torch.int32,
                          device=device).reshape(-1, 4)
    longest = max((n for _s, _c, _base, n in rows), default=0)
    return to_device(seqs, device), chains, total, longest


def decode_chains_device(comp: torch.Tensor, cols: list,
                         rows: list) -> torch.Tensor:
    """Decode several chains in one launch (arguments as
    :func:`pack_chains`); returns the uint8 tensor that holds chain
    ``k`` at ``[out_base, out_base + n_out)``."""
    seqs, chains, total, longest = pack_chains(cols, rows, comp.shape[0],
                                               comp.device)
    return segment_decode(comp, seqs, chains, total,
                          zero_fill=not covers(cols, rows),
                          max_chain=longest)


def decode_chain_device(
    comp: np.ndarray,        # uint8: chain-relevant slice of the input
    dst: np.ndarray,         # int32 [S] output byte offsets (chain-local)
    lit_src: np.ndarray,     # int32 [S] literal offsets into `comp`
    lit_len: np.ndarray,     # int32 [S]
    match_off: np.ndarray,   # int32 [S]
    match_len: np.ndarray,   # int32 [S]
    n_out: int,
    device="cuda",
) -> torch.Tensor:
    """Decode one chain; returns the uint8 ``(n_out,)`` tensor on
    ``device``."""
    return decode_chains_device(
        to_device(comp, device),
        [(dst, lit_src, lit_len, match_off, match_len)],
        [(dst.size, 0, 0, n_out)])


def decode_chain(
    comp: np.ndarray,
    dst: np.ndarray,
    lit_src: np.ndarray,
    lit_len: np.ndarray,
    match_off: np.ndarray,
    match_len: np.ndarray,
    n_out: int,
    device="cuda",
) -> np.ndarray:
    """Decode one chain on ``device``; returns uint8[n_out] on host."""
    return decode_chain_device(
        comp, dst, lit_src, lit_len, match_off, match_len, n_out,
        device=device,
    ).cpu().numpy()
