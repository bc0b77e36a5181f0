"""Format constants and memory-reservation policy enums.

Behavioral parity targets (reference file:line):
  - magics: lib/lz4ada.ads:348-353
  - history window / block size word width: lib/lz4ada.ads:350-351
  - reservation enum + aliases: lib/lz4ada.ads:80-106
  - block-size LUT: lib/lz4ada.adb:65-77
"""

from __future__ import annotations

import enum

KIB = 1024
MIB = 1024 * KIB

MAGIC_MODERN = 0x184D2204
MAGIC_LEGACY = 0x184C2102
SKIPPABLE_LO = 0x184D2A50
SKIPPABLE_HI = 0x184D2A5F

#: Sliding history window reachable by back-references (64 KiB).
HISTORY_SIZE = 64 * KIB

#: Size in bytes of a block length word.
BLOCK_SIZE_BYTES = 4

#: Quirk kept for parity: the modern size word is masked to 27 bits, not 31
#: (reference: lz4ada.adb:538). Harmless because anything > 8 MiB is
#: rejected against the buffer bound right after.
MODERN_SIZE_MASK = 0x7FFFFFF

#: Uncompressed-block flag: top bit of the modern size word, 1 = stored.
UNCOMPRESSED_BIT = 0x80000000


class Reservation(enum.IntEnum):
    """Block-buffer reservation policy.

    Ordering matters: larger value = larger (or more flexible) request,
    mirroring the reference's ``Flexible_Memory_Reservation`` ordering so
    the upgrade/conflict logic is a plain comparison.
    """

    SZ_64_KIB = 0
    SZ_256_KIB = 1
    SZ_1_MIB = 2
    SZ_4_MIB = 3
    SZ_8_MIB = 4
    #: Size buffers from the first frame header seen.
    USE_FIRST = 5
    #: Like USE_FIRST but refuse any data after the first frame ends.
    SINGLE_FRAME = 6

    @property
    def is_concrete(self) -> bool:
        """True for the five fixed-size reservations."""
        return self <= Reservation.SZ_8_MIB

    @property
    def ada_image(self) -> str:
        """Enum literal as Ada's 'Image renders it (uppercase)."""
        return self.name


FOR_MODERN = Reservation.SZ_4_MIB
FOR_LEGACY = Reservation.SZ_8_MIB
FOR_ALL = Reservation.SZ_8_MIB

_BLOCK_SIZE_LUT = {
    Reservation.SZ_64_KIB: 64 * KIB,
    Reservation.SZ_256_KIB: 256 * KIB,
    Reservation.SZ_1_MIB: 1 * MIB,
    Reservation.SZ_4_MIB: 4 * MIB,
    Reservation.SZ_8_MIB: 8 * MIB,
}


def block_size_of(reservation: Reservation) -> int:
    """Maximum block size implied by a concrete reservation."""
    return _BLOCK_SIZE_LUT[Reservation(reservation)]


def reservation_for_bd_code(code: int) -> Reservation:
    """Map a frame descriptor BD max-block-size code (4..7) to a reservation.

    Raises NotSupported for out-of-range codes
    (reference: lz4ada.adb:316-328).
    """
    from .errors import err_bad_block_size_flag

    table = {
        4: Reservation.SZ_64_KIB,
        5: Reservation.SZ_256_KIB,
        6: Reservation.SZ_1_MIB,
        7: Reservation.SZ_4_MIB,
    }
    try:
        return table[code]
    except KeyError:
        raise err_bad_block_size_flag(code) from None


class EndOfFrame(enum.Enum):
    """Tri-state end-of-frame status (reference: lz4ada.ads:108-124).

    MAYBE occurs for legacy frames, which have no end marker: a legacy
    frame may end at any block boundary, only the next bytes (or EOF of
    the data source) disambiguate.
    """

    NO = 0
    MAYBE = 1
    YES = 2


def is_any_magic(word: int) -> bool:
    """True if the 32-bit word is a modern/legacy/skippable frame magic."""
    return (
        word == MAGIC_MODERN
        or word == MAGIC_LEGACY
        or SKIPPABLE_LO <= word <= SKIPPABLE_HI
    )
