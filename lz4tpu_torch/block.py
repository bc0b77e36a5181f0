"""Host-side LZ4 block decoding over the wrapped-ring output buffer.

This is the exact-semantics oracle: it reproduces the reference's block
grammar, ring arithmetic, and every diagnostic value bit-for-bit
(reference: lib/lz4ada.adb:716-904). The fast path is the native engine
(lz4tpu_torch.native); when the native path reports a failure, callers re-run
the block through :func:`decode_block_ring_py` to get the contract-exact
error message.

The ring model (reference: lz4ada.adb:678-680, 845-904): one buffer of
``block_max + 64 KiB + 8`` bytes. ``out_pos`` is the write cursor; when a
block starts with ``out_pos >= 64 KiB`` the cursor wraps to 0 and
``out_pos_history`` remembers where the previous region ended. A
back-reference at distance ``offset`` reads from ``out_pos - offset`` if
that is >= 0, else from ``out_pos - offset + out_pos_history`` (the tail
of the previous region, still intact because writes from 0 can never
catch up with it while offsets are <= 64 KiB - 1).
"""

from __future__ import annotations

import numpy as np

from .errors import (
    DataCorruption,
    err_backref_out_of_range,
    err_match_after_literals,
    err_offset_zero,
)

__all__ = ["decode_block_ring_py", "decode_block_ring", "decode_block"]


def _var_length(src: np.ndarray, ip: int, base: int) -> tuple[int, int]:
    """Decode a 255-chained length extension; returns (value, new_ip)."""
    v = base
    if base == 15:
        n = src.size
        while True:
            if ip >= n:
                raise DataCorruption("Truncated sequence: length bytes missing.")
            b = int(src[ip])
            ip += 1
            v += b
            if b != 255:
                break
    return v, ip


def decode_block_ring_py(
    src: np.ndarray,
    buf: np.ndarray,
    out_pos: int,
    out_pos_history: int,
) -> int:
    """Decode one raw block into `buf` at `out_pos`; returns new out_pos.

    Raises DataCorruption with reference-exact messages on malformed data.
    """
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n = src.size
    ip = 0
    op = out_pos
    while ip < n:
        token = int(src[ip])
        ip += 1
        lit, ip = _var_length(src, ip, token >> 4)
        if ip + lit > n:
            # Literal run claims more bytes than the block holds. The
            # reference (checks suppressed) would copy past the end and
            # only fail at the match-nibble check below
            # (reference: lz4ada.adb:752-764); report at the same point.
            if token & 0x0F:
                raise err_match_after_literals(token & 0x0F)
            raise DataCorruption("Truncated sequence: literals missing.")
        if lit > 0:
            if op + lit > buf.size:
                raise DataCorruption(
                    "Decoded data exceeds the maximum block size."
                )
            buf[op:op + lit] = src[ip:ip + lit]
            ip += lit
            op += lit
        if ip >= n:
            if token & 0x0F:
                raise err_match_after_literals(token & 0x0F)
            break
        if ip + 2 > n:
            raise DataCorruption("Truncated sequence: offset bytes missing.")
        offset = int(src[ip]) | (int(src[ip + 1]) << 8)
        ip += 2
        if offset == 0:
            raise err_offset_zero()
        mlen, ip = _var_length(src, ip, token & 0x0F)
        mlen += 4
        if op + mlen > buf.size:
            raise DataCorruption("Decoded data exceeds the maximum block size.")

        raw = op - offset
        remaining = mlen
        if raw < 0:
            h_off = raw + out_pos_history
            if h_off < 0:
                raise err_backref_out_of_range(h_off)
            h_len = min(remaining, offset - op)
            if h_len > 0:
                buf[op:op + h_len] = buf[h_off:h_off + h_len]
                op += h_len
                remaining -= h_len
            raw = 0
        # Copy from the span [raw, op); when the match overlaps its own
        # output, replay the span log-doubling style.
        while remaining > 0:
            chunk = min(op - raw, remaining)
            buf[op:op + chunk] = buf[raw:raw + chunk]
            op += chunk
            remaining -= chunk
    return op


def decode_block_ring(
    src,
    buf: np.ndarray,
    out_pos: int,
    out_pos_history: int,
) -> int:
    """Native-accelerated ring decode with exact-error fallback."""
    src = np.ascontiguousarray(
        src if isinstance(src, np.ndarray) else np.frombuffer(bytes(src), np.uint8),
        dtype=np.uint8,
    )
    try:
        from . import native
    except Exception:
        native = None
    if native is not None and native.available():
        status, new_pos, _err = native.decode_block_ring(
            src, buf, out_pos, out_pos_history
        )
        if status == native.OK:
            return new_pos
        # Re-run through the oracle for the contract-exact diagnostic.
        # (The native fast path may have partially written `buf`; the
        # oracle restart is fine because every write is re-derived.)
        return decode_block_ring_py(src, buf, out_pos, out_pos_history)
    return decode_block_ring_py(src, buf, out_pos, out_pos_history)


def decode_block(src, max_out: int = 1 << 23) -> bytes:
    """Decode a single independent raw block (no frame, no history)."""
    buf = np.zeros(max_out + 8, dtype=np.uint8)
    end = decode_block_ring(src, buf, 0, 0)
    return buf[:end].tobytes()
