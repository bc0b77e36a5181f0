"""Streaming LZ4 decompressor: incremental push parser with byte-granular
re-entrancy.

This is the host-side streaming facade of the framework. It accepts input
in arbitrary chunk sizes (down to one byte), maintains the frame-header
FSM, the block-length detector, the input cache and the wrapped-ring
output window, and defers the block hot loop to the native engine
(lz4tpu_torch.native) with the pure-Python oracle (lz4tpu_torch.block) as fallback
and exact-diagnostics path.

Behavioral parity with the reference streaming core
(reference: lib/lz4ada.adb:383-714, state records lib/lz4ada.ads:359-370,
440-449) including:
  - frame-header FSM with incremental byte accounting
  - modern / legacy / skippable magics, concatenated frames,
    legacy->modern transitions recognized in place of a block size word
  - block & content checksum verification, content-size accounting
  - Single_Frame policy errors
  - the 27-bit size-word mask quirk (constants.MODERN_SIZE_MASK)
  - EOF tri-state (legacy frames report MAYBE at block boundaries)

Documented divergences from the reference (behavior judged accidental):
  - a skippable frame no longer *downgrades* the retained memory
    reservation to 64 KiB for subsequent frames (reference:
    lz4ada.adb:177 combined with adb:241-260 makes any later frame
    with blocks > 64 KiB fail); we keep the user's policy sticky. With
    Reservation.USE_FIRST/SINGLE_FRAME a leading skippable frame still
    sizes buffers at 64 KiB exactly like the reference.
  - raw-block mode (for_block) assembles fragmented input correctly
    (the reference drops the first 4 cached bytes in that mode,
    lz4ada.adb:654).
"""

from __future__ import annotations

import enum

import numpy as np

from . import block as _block
from .constants import (
    BLOCK_SIZE_BYTES,
    FOR_ALL,
    FOR_LEGACY,
    HISTORY_SIZE,
    MAGIC_LEGACY,
    MAGIC_MODERN,
    MODERN_SIZE_MASK,
    SKIPPABLE_LO,
    SKIPPABLE_HI,
    EndOfFrame,
    Reservation,
    block_size_of,
    is_any_magic,
    reservation_for_bd_code,
)
from .errors import (
    TooLittleMemory,
    err_backref_out_of_range,  # noqa: F401  (re-export convenience)
    err_bad_magic,
    err_bad_version,
    err_block_checksum,
    err_block_too_large,
    err_content_checksum,
    err_content_size_exceeded,
    err_content_size_leftover,
    err_header_checksum,
    err_reserved_bits,
    err_single_frame_next_frame,
    err_single_frame_trailing,
    err_too_few_header_bytes,
    err_too_little_memory,
)
from .xxh32 import XXHash32, xxh32

__all__ = ["Decompressor", "Format"]


class Format(enum.Enum):
    TBD = 0
    LEGACY = 1
    MODERN = 2
    BLOCK = 3
    SKIPPABLE = 4


class _HState(enum.Enum):
    NEED_MAGIC = 0
    NEED_FLAGS = 1
    NEED_MODERN = 2
    NEED_SKIPPABLE_LENGTH = 3
    COMPLETE = 4


def _new_hasher():
    try:
        from .native import NativeXXH32, available

        if available():
            return NativeXXH32()
    except Exception:
        pass
    return XXHash32()


def _le32(buf: np.ndarray, off: int = 0) -> int:
    return (
        int(buf[off])
        | (int(buf[off + 1]) << 8)
        | (int(buf[off + 2]) << 16)
        | (int(buf[off + 3]) << 24)
    )


def _le64(buf: np.ndarray, off: int = 0) -> int:
    return _le32(buf, off) | (_le32(buf, off + 4) << 32)


class Decompressor:
    """Incremental LZ4 frame/legacy/skippable/raw-block decompressor.

    Use one of the constructors:

    - ``Decompressor(reservation=...)`` — like the reference ``Init``:
      buffers sized from the reservation, header parsed from the stream.
    - ``Decompressor.from_header(data, reservation=...)`` — parse the
      frame header from ``data`` first (raises TooFewHeaderBytes if
      short); returns ``(ctx, consumed)``.
    - ``Decompressor.for_block(compressed_length, reservation=...)`` —
      raw single-block mode.

    Then repeatedly call :meth:`update`.
    """

    # -- construction ------------------------------------------------------

    def __init__(self, reservation: Reservation = FOR_ALL, *, _defer: bool = False):
        reservation = Reservation(reservation)
        self._format = Format.TBD
        self._hstate = _HState.NEED_MAGIC
        self._reservation: Reservation = reservation
        self._content_checksum_len = 0
        self._block_checksum_len = 0
        self._status_eof = EndOfFrame.NO
        self._filled = 0  # bytes buffered in self._inbuf
        self._is_compressed = False
        self._has_content_size = False
        self._size_remaining = 4  # multi-purpose byte counter (header/skip/content)

        self._at_end_mark = False
        self._output_pos = 0
        self._output_pos_history = 0
        self._input_length = -1  # declared current block length, -1 = unknown
        self._hash_all = _new_hasher()

        if _defer:
            # from_header/for_block fill in buffers after meta is known.
            self._inbuf = np.zeros(20, dtype=np.uint8)
            self._buffer = None
            self.min_buffer_size = 0
            return
        if not reservation.is_concrete:
            raise ValueError(
                "plain constructor needs a concrete reservation; use "
                "from_header() for USE_FIRST/SINGLE_FRAME"
            )
        block_max = block_size_of(reservation)
        self._alloc(block_max, in_last=block_max + 4 + BLOCK_SIZE_BYTES - 1)

    def _alloc(self, block_max: int, in_last: int) -> None:
        self.min_buffer_size = block_max + HISTORY_SIZE + 8
        self._inbuf = np.zeros(in_last + 1, dtype=np.uint8)
        self._buffer = np.zeros(self.min_buffer_size, dtype=np.uint8)

    @classmethod
    def from_header(
        cls, data, reservation: Reservation = Reservation.SINGLE_FRAME
    ) -> tuple["Decompressor", int]:
        """Create from caller-supplied header bytes; returns (ctx, consumed)."""
        reservation = Reservation(reservation)
        ctx = cls(_defer=True)
        # Parse as USE_FIRST so the header determines the block size even
        # under SINGLE_FRAME policy (reference: lz4ada.adb:93-96).
        ctx._reservation = (
            Reservation.USE_FIRST
            if reservation == Reservation.SINGLE_FRAME
            else reservation
        )
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        pos = 0
        consumed = 0
        while ctx._hstate != _HState.COMPLETE:
            if pos >= arr.size:
                raise err_too_few_header_bytes(ctx._size_remaining)
            inner = ctx._process_header_bytes(arr[pos:])
            pos += inner
            consumed += inner
        block_max = block_size_of(ctx._reservation)
        ctx._alloc(
            block_max,
            in_last=block_max + ctx._block_checksum_len + BLOCK_SIZE_BYTES - 1,
        )
        if reservation == Reservation.SINGLE_FRAME:
            ctx._reservation = Reservation.SINGLE_FRAME
        return ctx, consumed

    @classmethod
    def for_block(
        cls, compressed_length: int, reservation: Reservation = FOR_ALL
    ) -> "Decompressor":
        """Raw single-block mode (reference: Init_For_Block)."""
        reservation = Reservation(reservation)
        ctx = cls(_defer=True)
        ctx._reservation = reservation
        ctx._format = Format.BLOCK
        ctx._is_compressed = True
        ctx._hstate = _HState.COMPLETE
        ctx._input_length = compressed_length
        block_max = block_size_of(reservation)
        ctx._alloc(block_max, in_last=block_max - 1)
        return ctx

    # -- public surface ----------------------------------------------------

    @property
    def end_of_frame(self) -> EndOfFrame:
        """Tri-state EOF (reference: lz4ada.adb:906-915)."""
        if self._format == Format.LEGACY:
            return EndOfFrame.MAYBE if self._at_end_mark else self._status_eof
        if self._format == Format.BLOCK:
            return EndOfFrame.YES if self._input_length == -1 else EndOfFrame.NO
        return self._status_eof

    def is_end_of_frame(self) -> EndOfFrame:
        return self.end_of_frame

    def update(self, data) -> tuple[int, bytes]:
        """Feed bytes; returns ``(num_consumed, output_bytes)``.

        Not all input is necessarily consumed — callers loop, re-offering
        the unconsumed tail, exactly like the reference contract
        (reference: README.md:462-481).
        """
        consumed, out_first, out_last = self._update_spans(data)
        if out_last >= out_first:
            return consumed, self._buffer[out_first:out_last + 1].tobytes()
        return consumed, b""

    def update_into(self, data, buffer) -> tuple[int, int, int]:
        """Caller-owned-buffer Update (reference: lz4ada.ads:189-220).

        ``buffer`` is a writable byte buffer (numpy uint8 array,
        bytearray, or writable memoryview) of at least
        :attr:`min_buffer_size` bytes, supplied on EVERY call exactly
        like the reference's ``Buffer: in out`` parameter.  Output is
        written into it in place and ``(num_consumed, output_first,
        output_last)`` is returned — an INCLUSIVE index pair like the
        reference's ``Output_First/Output_Last`` (empty output when
        ``output_last < output_first``).  The buffer doubles as the
        64 KiB history window: its contents must not be modified
        between calls, and no copy of the output is made.

        Raises :class:`TooLittleMemory` when the buffer is smaller than
        ``min_buffer_size`` (the reference gets this check for free
        from Ada array bounds)."""
        if isinstance(buffer, np.ndarray):
            if buffer.dtype != np.uint8 or buffer.ndim != 1:
                raise ValueError("buffer must be a 1-D uint8 array")
            view = buffer
        else:
            mv = memoryview(buffer)
            if mv.readonly:
                raise ValueError("buffer must be writable")
            view = np.frombuffer(mv, dtype=np.uint8)
        if view.size < self.min_buffer_size:
            # Python-surface check; the reference gets it from Ada
            # array bounds, so there is no .eds message to match.
            raise TooLittleMemory(
                f"caller buffer of {view.size} bytes is below "
                f"min_buffer_size {self.min_buffer_size}"
            )
        prev, self._buffer = self._buffer, view
        try:
            consumed, out_first, out_last = self._update_spans(data)
        except BaseException:
            self._buffer = prev
            raise
        # keep reading history from the caller's buffer on the internal
        # paths too (update() after update_into() sees the same state)
        return consumed, out_first, out_last

    def _update_spans(self, data) -> tuple[int, int, int]:
        arr = (
            data
            if isinstance(data, np.ndarray) and data.dtype == np.uint8
            else np.frombuffer(bytes(data), dtype=np.uint8)
        )
        if arr.size == 0:
            return 0, 1, 0
        out_first, out_last = 1, 0
        if self._hstate != _HState.COMPLETE:
            consumed = self._process_header_bytes(arr)
        elif self._format == Format.SKIPPABLE:
            consumed = self._skip(arr)
        elif self._at_end_mark:
            consumed = self._check_end_mark(arr, 0)
        elif self._input_length != -1:
            consumed, out_first, out_last = self._cache_and_process(arr, 0)
        else:
            consumed = self._try_detect_input_length(arr)
            if self._at_end_mark:
                consumed = self._check_end_mark(arr, consumed)
            elif self._input_length != -1:
                consumed, out_first, out_last = self._handle_new_length(
                    arr, consumed
                )
        return consumed, out_first, out_last

    # -- header FSM --------------------------------------------------------

    def _process_header_bytes(self, arr: np.ndarray) -> int:
        """Buffer header bytes; dispatch when the current field is full."""
        take = min(arr.size, int(self._size_remaining))
        self._inbuf[self._filled:self._filled + take] = arr[:take]
        self._filled += take
        self._size_remaining -= take
        if self._size_remaining == 0:
            if self._hstate == _HState.NEED_MAGIC:
                self._process_header_magic(_le32(self._inbuf))
            elif self._hstate == _HState.NEED_FLAGS:
                self._process_header_flags()
            elif self._hstate == _HState.NEED_MODERN:
                self._process_modern_end_of_header()
            elif self._hstate == _HState.NEED_SKIPPABLE_LENGTH:
                if self._reservation == Reservation.USE_FIRST:
                    # Size buffers minimally when the first frame is
                    # skippable (reference: lz4ada.adb:177).
                    self._reservation = Reservation.SZ_64_KIB
                self._hstate = _HState.COMPLETE
                self._size_remaining = _le32(self._inbuf, 4)
                self._status_eof = (
                    EndOfFrame.YES if self._size_remaining == 0 else EndOfFrame.NO
                )
                self._filled = 0
        return take

    def _process_header_magic(self, magic: int) -> None:
        if magic == MAGIC_MODERN:
            self._format = Format.MODERN
            self._hstate = _HState.NEED_FLAGS
            self._size_remaining = 2
        elif magic == MAGIC_LEGACY:
            self._process_legacy_end_of_header()
        elif SKIPPABLE_LO <= magic <= SKIPPABLE_HI:
            self._format = Format.SKIPPABLE
            self._hstate = _HState.NEED_SKIPPABLE_LENGTH
            self._size_remaining = 4
            self._block_checksum_len = 0
            self._content_checksum_len = 0
        else:
            raise err_bad_magic(magic)

    def _process_legacy_end_of_header(self) -> None:
        self._filled = 0
        self._format = Format.LEGACY
        self._hstate = _HState.COMPLETE
        self._size_remaining = 0
        self._status_eof = EndOfFrame.MAYBE
        self._block_checksum_len = 0
        self._content_checksum_len = 0
        self._has_content_size = False
        self._is_compressed = True
        self._reservation = self._check_reservation(FOR_LEGACY)

    def _check_reservation(self, required: Reservation) -> Reservation:
        """Upgrade/conflict logic (reference: lz4ada.adb:241-260)."""
        requested = self._reservation
        if requested.is_concrete:
            if required > requested:
                raise err_too_little_memory(
                    required.ada_image, requested.ada_image
                )
            return requested
        return required

    def _process_header_flags(self) -> None:
        flg = int(self._inbuf[4])
        bd = int(self._inbuf[5])
        version = (flg & 0xC0) >> 6
        if version != 1:
            raise err_bad_version(version)
        if (flg & 0x02) or (bd & 0x8F):
            raise err_reserved_bits()
        # NB: the block-independence bit (flg & 0x20) is accepted and not
        # needed for streaming decode — history is always retained, so
        # both linked and independent blocks decode correctly (the
        # reference behaves the same way; the batched device pipeline
        # does use it, see lz4tpu_torch/pipeline.py).
        self._status_eof = EndOfFrame.NO
        required = reservation_for_bd_code((bd & 0x70) >> 4)
        self._block_checksum_len = 4 if (flg & 0x10) else 0
        self._content_checksum_len = 4 if (flg & 0x04) else 0
        self._has_content_size = bool(flg & 0x08)
        self._hstate = _HState.NEED_MODERN
        self._size_remaining = 1 + (8 if self._has_content_size else 0) + (
            4 if (flg & 0x01) else 0
        )
        effective = self._check_reservation(required)
        if self._reservation != Reservation.SINGLE_FRAME:
            self._reservation = effective

    def _process_modern_end_of_header(self) -> None:
        checksum_byte = int(self._inbuf[self._filled - 1])
        if self._has_content_size:
            self._size_remaining = _le64(self._inbuf, 6)
        else:
            self._size_remaining = 0
        descriptor = self._inbuf[4:self._filled - 1]
        computed = (xxh32(descriptor.tobytes()) >> 8) & 0xFF
        if checksum_byte != computed:
            raise err_header_checksum(computed, checksum_byte)
        self._hstate = _HState.COMPLETE
        self._filled = 0

    # -- frame lifecycle ---------------------------------------------------

    def _skip(self, arr: np.ndarray) -> int:
        remain = self._size_remaining
        take = min(arr.size, remain)
        if self._status_eof == EndOfFrame.YES and take == 0:
            return self._reset_for_next_frame(arr)
        self._size_remaining = remain - take
        self._status_eof = (
            EndOfFrame.YES if self._size_remaining == 0 else EndOfFrame.NO
        )
        return take

    def _reset_for_next_frame(self, arr: np.ndarray) -> int:
        if self._reservation == Reservation.SINGLE_FRAME:
            raise err_single_frame_trailing()
        self._status_eof = EndOfFrame.NO
        self._hstate = _HState.NEED_MAGIC
        self._size_remaining = 4
        self._reset_outer_for_next_frame()
        return self._process_header_bytes(arr)

    def _reset_outer_for_next_frame(self) -> None:
        self._at_end_mark = False
        self._input_length = -1
        self._output_pos = 0
        self._output_pos_history = 0
        self._hash_all.reset()

    def _set_frame_has_ended(self) -> None:
        self._status_eof = EndOfFrame.YES
        self._filled = 0
        if self._has_content_size and self._size_remaining != 0:
            raise err_content_size_leftover(self._size_remaining)

    def _check_end_mark(self, arr: np.ndarray, consumed: int) -> int:
        provided = arr.size - consumed
        required = self._content_checksum_len - self._filled
        if (
            self._content_checksum_len == 0
            or self._status_eof == EndOfFrame.YES
            or required <= 0
        ):
            if self._status_eof == EndOfFrame.YES:
                return self._reset_for_next_frame(arr)
            self._set_frame_has_ended()
            return consumed
        if provided >= required:
            tail = np.concatenate(
                [self._inbuf[: self._filled], arr[consumed:consumed + required]]
            )
            declared = _le32(tail)
            computed = self._hash_all.final()
            consumed += required
            if declared != computed:
                raise err_content_checksum(computed, declared)
            self._set_frame_has_ended()
            return consumed
        self._inbuf[self._filled:self._filled + provided] = arr[consumed:]
        self._filled += provided
        return consumed + provided

    # -- block length detection & caching -----------------------------------

    def _try_detect_input_length(self, arr: np.ndarray) -> int:
        take = min(BLOCK_SIZE_BYTES - self._filled, arr.size)
        self._inbuf[self._filled:self._filled + take] = arr[:take]
        self._filled += take
        if self._filled != BLOCK_SIZE_BYTES:
            return take
        word = _le32(self._inbuf)
        if self._format == Format.MODERN and word == 0:
            self._at_end_mark = True
            self._filled = 0
            return take
        if self._format == Format.LEGACY and is_any_magic(word):
            if self._reservation == Reservation.SINGLE_FRAME:
                raise err_single_frame_next_frame()
            self._reset_outer_for_next_frame()
            self._process_header_magic(word)
            return take
        # Modern: top bit means *uncompressed*; the size is masked to 27
        # bits, a reference quirk that is harmless because anything over
        # the buffer bound is rejected below.
        if self._format == Format.MODERN:
            self._is_compressed = (word & 0x80000000) == 0
            word &= MODERN_SIZE_MASK
        metadata = BLOCK_SIZE_BYTES + self._block_checksum_len
        self._input_length = word
        if self._input_length + metadata > self._inbuf.size:
            self._input_length = -1
            raise err_block_too_large(self._inbuf.size, word, metadata)
        return take

    def _handle_new_length(
        self, arr: np.ndarray, consumed: int
    ) -> tuple[int, int, int]:
        total = self._input_length + self._block_checksum_len
        if arr.size - consumed >= total:
            # Whole block already available: decode zero-copy from input.
            blk = arr[consumed:consumed + total]
            consumed += total
            self._filled = 0
            self._input_length = -1
            of, ol = self._decode_block_with_trailer(blk)
            return consumed, of, ol
        return self._cache_and_process(arr, consumed)

    def _cache_and_process(
        self, arr: np.ndarray, consumed: int
    ) -> tuple[int, int, int]:
        avail = arr.size - consumed
        skip = 0 if self._format == Format.BLOCK else BLOCK_SIZE_BYTES
        want = (
            self._input_length + self._block_checksum_len - self._filled + skip
        )
        if want > avail:
            self._inbuf[self._filled:self._filled + avail] = arr[consumed:]
            self._filled += avail
            return consumed + avail, 1, 0
        fill = self._filled
        blk = np.concatenate(
            [self._inbuf[skip:fill], arr[consumed:consumed + want]]
        )
        consumed += want
        self._filled = 0
        self._input_length = -1
        of, ol = self._decode_block_with_trailer(blk)
        return consumed, of, ol

    # -- block decode ------------------------------------------------------

    def _decode_block_with_trailer(self, blk: np.ndarray) -> tuple[int, int]:
        raw = blk[: blk.size - self._block_checksum_len]
        if self._block_checksum_len:
            declared = _le32(blk, blk.size - 4)
            computed = xxh32(raw.tobytes())
            if computed != declared:
                raise err_block_checksum(declared, computed)
        if self._output_pos >= HISTORY_SIZE:
            self._output_pos = 0
        start = self._output_pos
        if self._is_compressed:
            new_pos = _block.decode_block_ring(
                raw, self._buffer, start, self._output_pos_history
            )
        else:
            new_pos = start + raw.size
            self._buffer[start:new_pos] = raw
        produced = new_pos - start
        self._output_pos = new_pos
        self._decrease_content_size(produced)
        if self._content_checksum_len:
            self._hash_all.update(self._buffer[start:new_pos])
        if self._output_pos >= HISTORY_SIZE:
            self._output_pos_history = self._output_pos
        return start, new_pos - 1

    def _decrease_content_size(self, n: int) -> None:
        if self._has_content_size:
            if self._size_remaining < n:
                raise err_content_size_exceeded()
            self._size_remaining -= n
