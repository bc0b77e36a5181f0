"""Whole-buffer frame and block index parser (host side of the device
pipeline).

The streaming core (lz4tpu_torch.stream) is a push parser for incremental
input; this module is its batch counterpart: given a complete buffer it
walks every frame (modern / legacy / skippable, concatenated in any
mix), validates headers with the same error taxonomy and messages, and
emits a flat block index that the TPU pipeline consumes.

Validation performed here (identical checks and messages as the
streaming core): magic, version/reserved bits, BD code, header
checksum, block-size bound vs reservation, Single_Frame policy.
Payload-level checks (block/content checksums, sequence grammar,
back-reference range, content size accounting) happen in the pipeline
once payloads are scanned/decoded.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import (
    BLOCK_SIZE_BYTES,
    FOR_LEGACY,
    MAGIC_LEGACY,
    MAGIC_MODERN,
    MODERN_SIZE_MASK,
    SKIPPABLE_HI,
    SKIPPABLE_LO,
    Reservation,
    block_size_of,
    is_any_magic,
    reservation_for_bd_code,
)
from .errors import (
    DataCorruption,
    err_too_few_header_bytes,
    err_bad_magic,
    err_bad_version,
    err_block_too_large,
    err_header_checksum,
    err_reserved_bits,
    err_single_frame_next_frame,
    err_single_frame_trailing,
    err_too_little_memory,
)
from .xxh32 import xxh32


@dataclasses.dataclass
class BlockRec:
    """One LZ4 block inside a frame."""

    comp_off: int        # offset of the block payload in the input buffer
    comp_len: int        # payload length (without size word / checksum)
    is_compressed: bool
    checksum: int | None  # declared block checksum, if present
    frame_id: int


@dataclasses.dataclass
class FrameRec:
    """One parsed frame."""

    frame_id: int
    kind: str                    # "modern" | "legacy" | "skippable"
    start: int                   # offset of the magic
    header_end: int              # offset right after the header
    end: int                     # offset right after the frame
    block_independence: bool
    block_checksum: bool
    content_checksum: int | None  # declared value, if present
    content_size: int | None
    block_max: int
    blocks: list[BlockRec] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ParseResult:
    frames: list[FrameRec]
    blocks: list[BlockRec]


def _need(buf: np.ndarray, pos: int, n: int) -> None:
    if pos + n > buf.size:
        raise DataCorruption("Input ended in the middle of a frame.")


def _need_header(buf: np.ndarray, pos: int, n: int, policy: Reservation) -> None:
    """Header-region shortage: under from_header-style policies
    (USE_FIRST / SINGLE_FRAME) the reference raises Too_Few_Header_Bytes
    with the remaining byte count of the current header field
    (reference: lz4ada.adb:102-109)."""
    avail = buf.size - pos
    if avail < n:
        if not policy.is_concrete:
            raise err_too_few_header_bytes(n - avail)
        raise DataCorruption("Input ended in the middle of a frame.")


def _le32(buf: np.ndarray, off: int) -> int:
    return int(buf[off]) | (int(buf[off + 1]) << 8) | (int(buf[off + 2]) << 16) | (
        int(buf[off + 3]) << 24
    )


def _le64(buf: np.ndarray, off: int) -> int:
    return _le32(buf, off) | (_le32(buf, off + 4) << 32)


def parse_frames(
    data, reservation: Reservation = Reservation.SZ_8_MIB
) -> ParseResult:
    """Parse all concatenated frames in ``data`` into a block index."""
    buf = (
        data
        if isinstance(data, np.ndarray) and data.dtype == np.uint8
        else np.frombuffer(bytes(data), dtype=np.uint8)
    )
    reservation = Reservation(reservation)
    policy = reservation
    frames: list[FrameRec] = []
    blocks: list[BlockRec] = []
    pos = 0
    while pos < buf.size:
        if frames and policy == Reservation.SINGLE_FRAME:
            raise err_single_frame_trailing()
        _need_header(buf, pos, 4, policy)
        magic = _le32(buf, pos)
        fid = len(frames)
        if frames and frames[-1].kind == "legacy" and _cut_after_legacy(
                buf, pos, magic):
            break
        if magic == MAGIC_MODERN:
            frame, pos = _parse_modern(buf, pos, fid, policy)
        elif magic == MAGIC_LEGACY:
            frame, pos = _parse_legacy(buf, pos, fid, policy)
        elif SKIPPABLE_LO <= magic <= SKIPPABLE_HI:
            _need_header(buf, pos + 4, 4, policy)
            if policy == Reservation.USE_FIRST:
                # A leading skippable frame sizes buffers minimally
                # (reference: lz4ada.adb:177); later frames needing
                # more must raise Too_Little_Memory — same rule the
                # streaming core applies (stream.py), pinned by
                # tests/test_parity_edges.py.
                policy = Reservation.SZ_64_KIB
            length = _le32(buf, pos + 4)
            _need(buf, pos + 8, length)
            frame = FrameRec(
                frame_id=fid,
                kind="skippable",
                start=pos,
                header_end=pos + 8,
                end=pos + 8 + length,
                block_independence=True,
                block_checksum=False,
                content_checksum=None,
                content_size=None,
                block_max=0,
            )
            pos = frame.end
        else:
            raise err_bad_magic(magic)
        frames.append(frame)
        blocks.extend(frame.blocks)
    return ParseResult(frames=frames, blocks=blocks)


def _cut_after_legacy(buf: np.ndarray, pos: int, magic: int) -> bool:
    """Whether input ending inside the next frame's header at ``pos`` ends
    the stream cleanly after a legacy frame.  The streaming core reads
    the magic that ends a legacy frame as the next header and keeps the
    legacy frame's end of frame MAYBE until that header's FLG and BD
    bytes (modern) or its size word (skippable) are read: input that
    ends before them decodes without an error."""
    left = buf.size - pos - 4
    if magic == MAGIC_MODERN:
        return left < 2
    return SKIPPABLE_LO <= magic <= SKIPPABLE_HI and left < 4


def _effective_reservation(
    policy: Reservation, required: Reservation
) -> Reservation:
    if policy.is_concrete:
        if required > policy:
            raise err_too_little_memory(required.ada_image, policy.ada_image)
        return policy
    return required


def _parse_modern(
    buf: np.ndarray, pos: int, fid: int, policy: Reservation
) -> tuple[FrameRec, int]:
    start = pos
    _need_header(buf, pos + 4, 2, policy)
    flg = int(buf[pos + 4])
    bd = int(buf[pos + 5])
    version = (flg & 0xC0) >> 6
    if version != 1:
        raise err_bad_version(version)
    if (flg & 0x02) or (bd & 0x8F):
        raise err_reserved_bits()
    required = reservation_for_bd_code((bd & 0x70) >> 4)
    effective = _effective_reservation(policy, required)
    block_max = block_size_of(effective)
    has_content_size = bool(flg & 0x08)
    has_dict = bool(flg & 0x01)
    desc_len = 2 + (8 if has_content_size else 0) + (4 if has_dict else 0)
    # Remaining header field after FLG/BD: optional content size,
    # optional dict id, and the header-checksum byte.
    _need_header(buf, pos + 6, desc_len - 2 + 1, policy)
    descriptor = buf[pos + 4:pos + 4 + desc_len]
    declared_hc = int(buf[pos + 4 + desc_len])
    computed_hc = (xxh32(descriptor.tobytes()) >> 8) & 0xFF
    if declared_hc != computed_hc:
        raise err_header_checksum(computed_hc, declared_hc)
    content_size = _le64(buf, pos + 6) if has_content_size else None
    block_checksum = bool(flg & 0x10)
    bck_len = 4 if block_checksum else 0
    header_end = pos + 4 + desc_len + 1
    frame = FrameRec(
        frame_id=fid,
        kind="modern",
        start=start,
        header_end=header_end,
        end=-1,
        block_independence=bool(flg & 0x20),
        block_checksum=block_checksum,
        content_checksum=None,
        content_size=content_size,
        block_max=block_max,
    )
    # The streaming core sizes its input buffer as block_max + 4 bytes
    # (always-reserved checksum slot) + 4 (size word); replicate the
    # bound so the error value matches (reference: lz4ada.adb:54-60,
    # 541-553).
    inbuf_len = block_max + bck_len + BLOCK_SIZE_BYTES
    pos = header_end
    while True:
        _need(buf, pos, 4)
        word = _le32(buf, pos)
        pos += 4
        if word == 0:
            break
        is_compressed = (word & 0x80000000) == 0
        size = word & MODERN_SIZE_MASK
        if size + BLOCK_SIZE_BYTES + bck_len > inbuf_len:
            raise err_block_too_large(inbuf_len, size, BLOCK_SIZE_BYTES + bck_len)
        _need(buf, pos, size + bck_len)
        checksum = _le32(buf, pos + size) if block_checksum else None
        frame.blocks.append(
            BlockRec(
                comp_off=pos,
                comp_len=size,
                is_compressed=is_compressed,
                checksum=checksum,
                frame_id=fid,
            )
        )
        pos += size + bck_len
    if flg & 0x04:
        _need(buf, pos, 4)
        frame.content_checksum = _le32(buf, pos)
        pos += 4
    frame.end = pos
    return frame, pos


def _parse_legacy(
    buf: np.ndarray, pos: int, fid: int, policy: Reservation
) -> tuple[FrameRec, int]:
    start = pos
    effective = _effective_reservation(policy, FOR_LEGACY)
    block_max = block_size_of(effective)
    inbuf_len = block_max + 4 + BLOCK_SIZE_BYTES
    frame = FrameRec(
        frame_id=fid,
        kind="legacy",
        start=start,
        header_end=start + 4,
        end=-1,
        block_independence=False,
        block_checksum=False,
        content_checksum=None,
        content_size=None,
        block_max=block_max,
    )
    pos += 4
    # Legacy frames have no end mark: they end at the next magic or at
    # end of input (reference: lz4ada.adb:567-580). Trailing fragments
    # shorter than a size word are tolerated, matching the streaming
    # core's MAYBE semantics.
    while pos + 4 <= buf.size:
        word = _le32(buf, pos)
        if is_any_magic(word):
            if policy == Reservation.SINGLE_FRAME:
                raise err_single_frame_next_frame()
            break
        pos += 4
        if word + BLOCK_SIZE_BYTES > inbuf_len:
            raise err_block_too_large(inbuf_len, word, BLOCK_SIZE_BYTES)
        if pos + word > buf.size:
            # A block that runs past the end of input: the streaming
            # core caches it and ends there, the frame's EOF still MAYBE,
            # so its bytes are dropped without an error.
            pos = buf.size
            break
        frame.blocks.append(
            BlockRec(
                comp_off=pos,
                comp_len=word,
                is_compressed=True,
                checksum=None,
                frame_id=fid,
            )
        )
        pos += word
    if pos + 4 > buf.size:
        pos = buf.size
    frame.end = pos
    return frame, pos
