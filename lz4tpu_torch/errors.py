"""Error taxonomy for the TPU-native LZ4 codec.

The exception *classes* mirror the five exceptions of the reference library
(reference: lib/lz4ada.ads:133-162) and the *message strings* are
byte-identical to the reference's diagnostics (reference: the ``raise``
sites in lib/lz4ada.adb), because the reference's black-box test suite
treats exact error text as part of the contract
(reference: test_suite/lz4test.adb:310-323, test_vectors_lz4/*.eds).

Messages embed integers via :func:`ada_img`, reproducing Ada's
``'Image`` attribute formatting (leading space for non-negative values).
"""

from __future__ import annotations

__all__ = [
    "Lz4Error",
    "ChecksumError",
    "DataCorruption",
    "NotSupported",
    "TooFewHeaderBytes",
    "TooLittleMemory",
    "ada_img",
    "hex8",
    "hex32",
]


def ada_img(n: int) -> str:
    """Render an integer the way Ada's ``'Image`` does.

    Non-negative values get a leading space (the sign slot), negative
    values render with their minus sign and no space.
    """
    return f" {n}" if n >= 0 else str(n)


def hex8(v: int) -> str:
    """Lowercase two-digit hex of a byte (reference: lz4ada.adb:363-368)."""
    return f"{v & 0xFF:02x}"


def hex32(v: int) -> str:
    """Lowercase eight-digit hex of a 32-bit word (lz4ada.adb:370-375)."""
    return f"{v & 0xFFFFFFFF:08x}"


class Lz4Error(Exception):
    """Base class for all LZ4 codec errors."""

    #: Name used when rendering in the reference Ada test-suite format.
    ada_name = "LZ4ADA.LZ4_ERROR"

    def ada_image(self) -> str:
        """Render like the Ada runtime prints an exception occurrence.

        Matches the first line of the reference ``.eds`` files:
        ``raised LZ4ADA.DATA_CORRUPTION : <message>``.
        """
        return f"raised {self.ada_name} : {self.args[0]}"


class ChecksumError(Lz4Error):
    """An xxhash32 checksum (header, block, or content) did not match."""

    ada_name = "LZ4ADA.CHECKSUM_ERROR"


class DataCorruption(Lz4Error):
    """Input violates structural invariants of the LZ4 formats."""

    ada_name = "LZ4ADA.DATA_CORRUPTION"


class NotSupported(Lz4Error):
    """Valid-looking but unsupported input (bad magic, version, flags)."""

    ada_name = "LZ4ADA.NOT_SUPPORTED"


class TooFewHeaderBytes(Lz4Error):
    """``Decompressor.from_header`` got fewer bytes than a full header."""

    ada_name = "LZ4ADA.TOO_FEW_HEADER_BYTES"


class TooLittleMemory(Lz4Error):
    """Frame requires a larger block buffer than the caller allowed."""

    ada_name = "LZ4ADA.TOO_LITTLE_MEMORY"


# ---------------------------------------------------------------------------
# Message factories: one per validation point, byte-identical to the
# reference's raise sites so the .eds error-parity suite passes.
# ---------------------------------------------------------------------------

def err_bad_magic(magic: int) -> NotSupported:
    # reference: lz4ada.adb:219-221
    return NotSupported(f"Invalid or unsupported magic: 0x{hex32(magic)}")


def err_bad_version(version: int) -> NotSupported:
    # reference: lz4ada.adb:303-307
    return NotSupported(
        "Only LZ4 frame format version 01 supported. "
        f"Detected 0x{hex8(version)} instead."
    )


def err_reserved_bits() -> NotSupported:
    # reference: lz4ada.adb:309-313
    return NotSupported(
        "Found reserved bits /= 0. Data might be too new to be "
        "processed by this implementation!"
    )


def err_bad_block_size_flag(code: int) -> NotSupported:
    # reference: lz4ada.adb:324-326
    return NotSupported(f"Unknown maximum block size flag: 0x{hex8(code)}")


def err_header_checksum(computed: int, expected: int) -> ChecksumError:
    # reference: lz4ada.adb:355-360
    return ChecksumError(
        f"Computed Header Checksum 0x{hex8(computed)} does not match "
        f"expected Header Checksum 0x{hex8(expected)}"
    )


def err_too_little_memory(effective_image: str, requested_image: str) -> TooLittleMemory:
    # reference: lz4ada.adb:246-253 (typo "requres" is part of the contract)
    return TooLittleMemory(
        f"LZ4 header requres reservation {effective_image}, but API call "
        f"requested that only {requested_image} be used. This frame cannot "
        "be processed under the given constraints."
    )


def err_too_few_header_bytes(more_needed: int) -> TooFewHeaderBytes:
    # reference: lz4ada.adb:104-108
    return TooFewHeaderBytes(
        f"Expected at least {ada_img(more_needed)} more bytes but header "
        "input has already ended."
    )


def err_single_frame_trailing() -> DataCorruption:
    # reference: lz4ada.adb:439-441
    return DataCorruption(
        "Requested Single_Frame operation but data was provided after "
        "End of Frame was detected"
    )


def err_single_frame_next_frame() -> DataCorruption:
    # reference: lz4ada.adb:573-577
    return DataCorruption(
        "Requested Single_Frame operation but data provided what looks "
        "like the beginning of another frame."
    )


def err_content_size_leftover(remaining: int) -> DataCorruption:
    # reference: lz4ada.adb:471-475
    return DataCorruption(
        "Frame has ended, but according to content size, there should "
        f"be {ada_img(remaining)} bytes left to output."
    )


def err_content_checksum(computed: int, declared: int) -> ChecksumError:
    # reference: lz4ada.adb:505-510
    return ChecksumError(
        f"Computed content checksum 0x{hex32(computed)} does not match "
        f"declared content checksum 0x{hex32(declared)}."
    )


def err_block_too_large(buffer_len: int, length_word: int, metadata: int) -> DataCorruption:
    # reference: lz4ada.adb:544-552
    return DataCorruption(
        f"Declared maximum data length exceeded. Buffer has "
        f"{ada_img(buffer_len)} bytes, current block requires "
        f"{ada_img(length_word)} bytes + {ada_img(metadata)} bytes for "
        "metadata."
    )


def err_block_checksum(expected: int, computed: int) -> ChecksumError:
    # reference: lz4ada.adb:702-705
    return ChecksumError(
        f"Declared checksum is 0x{hex32(expected)}, but computed one is "
        f"0x{hex32(computed)}."
    )


def err_match_after_literals(match_nibble: int) -> DataCorruption:
    # reference: lz4ada.adb:754-761
    return DataCorruption(
        f"Match_Length={ada_img(match_nibble)} suggests compressed data "
        "but this sequence already ends after the literals. This might "
        "also happen with an untypical encoder?"
    )


def err_offset_zero() -> DataCorruption:
    # reference: lz4ada.adb:770-771
    return DataCorruption("Corrupted Block: Offset = 0 detected.")


def err_backref_out_of_range(h_offset: int) -> DataCorruption:
    # reference: lz4ada.adb:868-873
    return DataCorruption(
        "Backreference location out of range. Read from offset "
        f"{ada_img(h_offset)} not possible (earliest available index is 0)."
    )


def err_content_size_exceeded() -> DataCorruption:
    # reference: lz4ada.adb:831-834
    return DataCorruption(
        "Produced content size exceeds declared content size. The "
        "supplied data is inconsistent."
    )
