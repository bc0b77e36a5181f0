"""High-level one-shot API: decompress / compress whole buffers.

``decompress`` routes through the host streaming engine by default and
through the batched GPU device pipeline when requested (or when
``backend="auto"`` finds a CUDA device and enough data to be worth
shipping).

The compressed *writer* (``compress``) produces standard LZ4 frames that
the reference CLI decodes bit-exactly; the match finder is the native
hash-chain engine (reference analog: none — the reference is
decompression-only, README.md:20; the encoder is a new capability per
the rebuild north star).
"""

from __future__ import annotations

import struct

import numpy as np

from .constants import (
    FOR_ALL,
    MAGIC_MODERN,
    EndOfFrame,
    Reservation,
)
from .errors import DataCorruption, Lz4Error
from .stream import Decompressor
from .trace import span
from .xxh32 import XXHash32, xxh32

__all__ = ["decompress", "compress", "decompress_host",
           "decompress_into", "min_buffer_size"]


def min_buffer_size(reservation: Reservation = FOR_ALL) -> int:
    """Minimum caller-buffer size for the caller-owned-buffer APIs.

    The reference's ``Init`` reports this as its ``Min_Buffer_Size``
    out-parameter (lz4ada.ads:189-220): one maximum block plus the
    64 KiB history window plus slack.  A buffer of this size passed to
    :meth:`Decompressor.update_into` doubles as the history window, so
    decoding allocates nothing per call."""
    from .constants import HISTORY_SIZE, block_size_of

    reservation = Reservation(reservation)
    if not reservation.is_concrete:
        reservation = FOR_ALL    # sized from the first header later;
        # FOR_ALL is the safe upper bound the reference also reports
    return block_size_of(reservation) + HISTORY_SIZE + 8


def decompress_into(data, dst, reservation: Reservation = FOR_ALL) -> int:
    """Decode a whole buffer into caller-owned storage; returns the
    decoded byte count.

    ``dst`` is a writable byte buffer (numpy uint8 array, bytearray, or
    writable memoryview) large enough for the full decoded output —
    the one-shot analog of the reference's caller-supplied-buffer
    ``Update`` (lz4ada.ads:189-220; the incremental analog with exact
    history-window semantics is :meth:`Decompressor.update_into`).
    Output lands in ``dst[:n]``; no output-sized allocation is made
    (the engine's 64 KiB-window ring is the only scratch).

    Raises ``ValueError`` when ``dst`` fills before the stream ends
    (``dst`` contents beyond the last complete block are unspecified),
    plus the usual ``Lz4Error`` taxonomy for malformed input."""
    if isinstance(dst, np.ndarray):
        if dst.dtype != np.uint8 or dst.ndim != 1:
            raise ValueError("dst must be a 1-D uint8 array")
        view = dst
    else:
        mv = memoryview(dst)
        if mv.readonly:
            raise ValueError("dst must be writable")
        view = np.frombuffer(mv, dtype=np.uint8)
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    if arr.size == 0:
        return 0
    reservation = Reservation(reservation)
    if reservation.is_concrete:
        ctx = Decompressor(reservation)
        pos = 0
    else:
        ctx, pos = Decompressor.from_header(arr, reservation)
    n = 0
    stall = 0
    while pos < arr.size:
        consumed, chunk = ctx.update(arr[pos:])
        if chunk:
            if n + len(chunk) > view.size:
                raise ValueError(
                    f"dst too small: decoded output exceeds "
                    f"{view.size} bytes"
                )
            view[n:n + len(chunk)] = np.frombuffer(chunk, np.uint8)
            n += len(chunk)
        pos += consumed
        if consumed == 0:
            stall += 1
            if stall > 4:
                raise DataCorruption(
                    "Decoder made no progress; corrupt input.")
        else:
            stall = 0
    if ctx.end_of_frame == EndOfFrame.NO:
        raise DataCorruption("Input ended in the middle of a frame.")
    return n


def _decompress_host_batch(arr: np.ndarray, reservation) -> bytes:
    """Linear-buffer batch decode: parse the frame/block index, then
    native-decode every block straight into one output array.

    Unlike the streaming ring (bounded memory, byte-at-a-time capable),
    a whole-buffer decode can use a linear per-frame output region:
    back-references index it directly and the decoder's wild-copy fast
    paths are always in range.  Raises on any anomaly; the caller falls
    back to the streaming engine, which reproduces the reference's
    exact diagnostics.
    """
    from . import native
    from .errors import err_block_checksum, err_content_checksum
    from .frame import parse_frames

    parsed = parse_frames(arr, reservation)
    parts: list = []
    for frame in parsed.frames:
        if frame.content_size is not None:
            cap = int(frame.content_size)
        else:
            # exact upper bound: block_max per compressed block
            cap = sum(
                frame.block_max if b.is_compressed else b.comp_len
                for b in frame.blocks
            )
        fbuf = np.empty(cap + 16, np.uint8)   # +16 wild-copy slack
        op = 0

        def grow():
            nonlocal cap, fbuf
            cap *= 2
            nbuf = np.empty(cap + 16, np.uint8)
            nbuf[:op] = fbuf[:op]
            fbuf = nbuf

        for blk in frame.blocks:
            payload = arr[blk.comp_off:blk.comp_off + blk.comp_len]
            if blk.checksum is not None:
                got = native.native_xxh32(payload)
                if got != blk.checksum:
                    raise err_block_checksum(blk.checksum, got)
            if not blk.is_compressed:
                while op + blk.comp_len > cap:
                    grow()
                fbuf[op:op + blk.comp_len] = payload
                op += blk.comp_len
                continue
            while True:
                st, new_op, _err = native.decode_block_ring(
                    payload, fbuf[: cap], op, 0
                )
                if st == native.OK:
                    op = new_op
                    break
                if st == native.E_DST_OVERFLOW and frame.content_size is None:
                    grow()
                    continue
                raise DataCorruption(f"block decode status {st}")
        if frame.content_size is not None and op != frame.content_size:
            raise DataCorruption("content size mismatch")
        if frame.content_checksum is not None:
            got = native.native_xxh32(fbuf[:op])
            if got != frame.content_checksum:
                raise err_content_checksum(got, frame.content_checksum)
        parts.append(fbuf[:op].tobytes())
    return b"".join(parts)  # single-part join returns it uncopied


def decompress_host(data, reservation: Reservation = FOR_ALL) -> bytes:
    """Decode a whole buffer (any mix of concatenated frames) on the host.

    Fast path: linear-buffer batch decode; any anomaly (malformed
    input, checksum mismatch, reservation conflict) re-runs the
    streaming engine, whose diagnostics are byte-identical to the
    reference's."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    if arr.size == 0:
        return b""
    try:
        return _decompress_host_batch(arr, reservation)
    except (Lz4Error, MemoryError):
        pass  # exact error (or quirk tolerance) via the streaming path
    return _decompress_host_streaming(arr, reservation)


def _decompress_host_streaming(arr, reservation: Reservation) -> bytes:
    reservation = Reservation(reservation)
    if reservation.is_concrete:
        ctx = Decompressor(reservation)
        pos = 0
    else:
        # flexible policies (USE_FIRST / SINGLE_FRAME) size buffers
        # from the first frame header
        ctx, pos = Decompressor.from_header(arr, reservation)
    out = bytearray()
    stall = 0
    while pos < arr.size:
        consumed, chunk = ctx.update(arr[pos:])
        out += chunk
        pos += consumed
        if consumed == 0:
            stall += 1
            if stall > 4:
                raise DataCorruption("Decoder made no progress; corrupt input.")
        else:
            stall = 0
    if ctx.end_of_frame == EndOfFrame.NO:
        raise DataCorruption("Input ended in the middle of a frame.")
    return bytes(out)


def decompress(data, reservation: Reservation = FOR_ALL,
               backend: str = "auto") -> bytes:
    """Decode a whole buffer.

    backend: "host" (native/C++ streaming engine), "device" (batched
    GPU pipeline; raises without a CUDA device), or "auto" (device when
    a CUDA device is present and the input is large enough to amortize
    dispatch).
    """
    if backend == "host":
        return decompress_host(data, reservation)
    if backend == "device":
        from .pipeline import decompress_device

        return decompress_device(data, reservation)
    # auto
    import torch

    if torch.cuda.is_available() and len(data) >= 1 << 16:
        from .pipeline import decompress_device

        return decompress_device(data, reservation)
    return decompress_host(data, reservation)


def _frame_descriptor(
    content_size: int | None,
    block_max_code: int,
    content_checksum: bool,
    block_checksum: bool,
    block_independence: bool,
) -> bytes:
    flg = (1 << 6) | (0x20 if block_independence else 0)
    if block_checksum:
        flg |= 0x10
    if content_size is not None:
        flg |= 0x08
    if content_checksum:
        flg |= 0x04
    bd = block_max_code << 4
    body = bytes([flg, bd])
    if content_size is not None:
        body += struct.pack("<Q", content_size)
    hc = (xxh32(body) >> 8) & 0xFF
    return body + bytes([hc])


_BLOCK_CODE_SIZE = {4: 64 * 1024, 5: 256 * 1024, 6: 1 << 20, 7: 4 << 20}


def compress(
    data,
    *,
    block_max_code: int = 7,
    content_checksum: bool = True,
    block_checksum: bool = False,
    content_size: bool = False,
    block_independence: bool = False,
    max_chain: int = 64,
    level: int = 6,
    backend: str = "host",
    frame_format: str = "modern",
    device="cuda",
) -> bytes:
    """Compress ``data`` into a standard LZ4 frame.

    Defaults mirror the ``lz4`` CLI (4 MiB linked blocks, content
    checksum on), which is what the reference test vectors use.
    ``level >= 10`` switches to the optimal parser (exact backward-DP
    sequence pricing; slowest, best ratio).

    ``backend="device"`` finds matches on ``device`` (sorted grams, the
    compact candidate stream) and emits tokens on the host;
    ``backend="device-emit"`` decides every match on ``device`` and only
    splices tokens on the host (``lz4tpu_torch.device.encode``).
    ``device`` is ``"cuda"`` by default, which raises where CUDA is
    absent, or ``"cpu"``; ``backend="host"`` ignores it.

    ``frame_format="legacy"`` writes the Legacy Frame Format (magic
    ``0x184C2102``, 8 MiB always-compressed blocks, no checksums, no
    end mark — reference: lz4ada.adb:225-239): 11 bytes less framing
    overhead, which is why the reference's tiny legacy vectors are
    smaller than any modern frame can be.

    Spans: ``encode`` (the request), ``encode.block`` a block and
    ``encode.checksum`` (the content checksum).
    """
    with span("encode"):
        data = bytes(data)
        from .native import compress_block

        if backend in ("device", "device-emit"):
            from .pipeline import _resolve_device

            device = _resolve_device(device)
        if backend == "device":
            from .device.encode import compress_block_device
        elif backend == "device-emit":
            from .device.encode import compress_block_device_emit

        # Search effort per level (lz4-CLI-like): 1-3 shallow chains and no
        # lazy deferral (speed), 4-9 the full lazy hash chain, >=10 the
        # exact optimal parse.
        eff_chain = min(max_chain, 8) if level <= 3 else max_chain
        eff_lazy = level >= 4

        if frame_format == "legacy":
            from .constants import MAGIC_LEGACY

            out = bytearray(struct.pack("<I", MAGIC_LEGACY))
            pos = 0
            block_max = 8 << 20
            while pos < len(data):
                chunk = data[pos:pos + block_max]
                # legacy blocks are always compressed and independent
                comp = compress_block(chunk, max_chain=eff_chain,
                                      optimal=level >= 10, lazy=eff_lazy)
                out += struct.pack("<I", len(comp))
                out += comp
                pos += len(chunk)
            return bytes(out)

        block_max = _BLOCK_CODE_SIZE[block_max_code]
        out = bytearray(struct.pack("<I", MAGIC_MODERN))
        out += _frame_descriptor(
            len(data) if content_size else None,
            block_max_code,
            content_checksum,
            block_checksum,
            block_independence,
        )
        pos = 0
        while pos < len(data):
            chunk = data[pos:pos + block_max]
            hist = b"" if block_independence else data[max(0, pos - 65536):pos]
            with span("encode.block"):
                if backend == "device":
                    # match finding on the device (sorted grams), host
                    # emission
                    comp = compress_block_device(chunk, hist=hist,
                                                 device=device)
                elif backend == "device-emit":
                    # every match decided on the device; the host only
                    # splices tokens
                    comp = compress_block_device_emit(chunk, hist=hist,
                                                      device=device)
                else:
                    comp = compress_block(
                        chunk, hist=hist, max_chain=eff_chain,
                        optimal=level >= 10, lazy=eff_lazy,
                    )
            if comp and len(comp) < len(chunk):
                out += struct.pack("<I", len(comp))
                out += comp
                blk = comp
            else:
                out += struct.pack("<I", len(chunk) | 0x80000000)
                out += chunk
                blk = chunk
            if block_checksum:
                out += struct.pack("<I", xxh32(blk))
            pos += len(chunk)
        out += b"\x00\x00\x00\x00"  # end mark
        if content_checksum:
            with span("encode.checksum"):
                out += struct.pack("<I", xxh32(data))
        return bytes(out)


class Compressor:
    """Incremental LZ4 frame compressor — the encode-side counterpart
    of the streaming :class:`~lz4tpu_torch.stream.Decompressor` (the
    reference is decode-only; its streaming contract is
    lib/lz4ada.ads:211-287).  Feed chunks with :meth:`update`, close
    the frame with :meth:`finish`; the concatenated output is
    bit-identical to :func:`compress` over the whole payload with the
    same options (pinned by tests/test_api_paths.py).

    ``content_size`` is unsupported by construction (the total length
    is unknown while streaming), matching the lz4 CLI's streaming
    mode.  History is linked across blocks unless
    ``block_independence``.
    """

    def __init__(
        self,
        *,
        block_max_code: int = 7,
        content_checksum: bool = True,
        block_checksum: bool = False,
        block_independence: bool = False,
        max_chain: int = 64,
        level: int = 6,
    ) -> None:
        self._block_max = _BLOCK_CODE_SIZE[block_max_code]
        self._content_checksum = content_checksum
        self._block_checksum = block_checksum
        self._block_independence = block_independence
        self._chain = min(max_chain, 8) if level <= 3 else max_chain
        self._lazy = level >= 4
        self._optimal = level >= 10
        self._buf = bytearray()
        self._hist = b""
        self._hasher = XXHash32() if content_checksum else None
        self._finished = False
        self._header = struct.pack("<I", MAGIC_MODERN) + _frame_descriptor(
            None, block_max_code, content_checksum, block_checksum,
            block_independence,
        )

    def _emit_block(self, chunk: bytes) -> bytes:
        from .native import compress_block

        comp = compress_block(
            chunk, hist=self._hist, max_chain=self._chain,
            optimal=self._optimal, lazy=self._lazy,
        )
        if comp and len(comp) < len(chunk):
            blk = comp
            out = struct.pack("<I", len(comp)) + comp
        else:
            blk = chunk
            out = struct.pack("<I", len(chunk) | 0x80000000) + chunk
        if self._block_checksum:
            out += struct.pack("<I", xxh32(blk))
        if not self._block_independence:
            self._hist = (self._hist + chunk)[-65536:]
        return out

    def update(self, data) -> bytes:
        """Feed bytes; returns whatever frame bytes are ready (the
        header on first call, then every completed block)."""
        if self._finished:
            raise ValueError("Compressor already finished")
        data = bytes(data)
        out = bytearray()
        if self._header is not None:
            out += self._header
            self._header = None
        if self._hasher is not None and data:
            self._hasher.update(data)
        self._buf += data
        while len(self._buf) >= self._block_max:
            chunk = bytes(self._buf[: self._block_max])
            del self._buf[: self._block_max]
            out += self._emit_block(chunk)
        return bytes(out)

    def finish(self) -> bytes:
        """Flush the final partial block, end mark, and content
        checksum; the Compressor cannot be used afterwards."""
        if self._finished:
            raise ValueError("Compressor already finished")
        self._finished = True
        out = bytearray()
        if self._header is not None:       # empty input: bare frame
            out += self._header
            self._header = None
        if self._buf:
            out += self._emit_block(bytes(self._buf))
            self._buf.clear()
        out += b"\x00\x00\x00\x00"
        if self._hasher is not None:
            out += struct.pack("<I", self._hasher.final())
        return bytes(out)
