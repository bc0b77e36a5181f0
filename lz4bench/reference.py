"""The plain reference: an LZ4 frame reader in Python and numpy, written
from the frame and block format alone.  It imports nothing of the
program and takes nothing the program made.

It judges the program's answers.  A decode's answer is judged against
the original bytes the benchmark generated (:mod:`lz4bench.corpora`), so
a decode cell needs no decoder at run time.  An encode's answer, a
frame, is judged by :func:`check_frame`: its descriptor against the
configuration, every block decoded here (sequence by sequence, with no
match reaching before its block where blocks are independent), the
bytes against the input, and the content checksum against the input's
xxhash32.  That hash is the benchmark's own frozen copy
(:func:`lz4bench.encoder.xxh32`): :func:`xxh32` here, in plain Python,
agrees with it (the benchmark's tests) but takes tens of seconds on
32 MiB.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

MAGIC = 0x184D2204
BLOCK_SIZE = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917, 668265263,
                           374761393)
_M = 0xFFFFFFFF


class FrameError(ValueError):
    """The frame breaks the format or its configuration."""


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 of ``data``, in plain Python."""
    n, p = len(data), 0
    if n >= 16:
        v = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M, seed & _M,
             (seed - _P1) & _M]
        words = struct.unpack_from(f"<{(n // 16) * 4}I", data)
        for i in range(0, len(words), 4):
            for j in range(4):
                v[j] = _rotl((v[j] + words[i + j] * _P2) & _M, 13) * _P1 & _M
        p = (n // 16) * 16
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while n - p >= 4:
        h = _rotl((h + struct.unpack_from("<I", data, p)[0] * _P3) & _M,
                  17) * _P4 & _M
        p += 4
    while p < n:
        h = _rotl((h + data[p] * _P5) & _M, 11) * _P1 & _M
        p += 1
    h ^= h >> 15
    h = h * _P2 & _M
    h ^= h >> 13
    h = h * _P3 & _M
    return h ^ (h >> 16)


def decode_block(src: bytes, out: bytearray, floor: int) -> None:
    """Append the decoded bytes of one LZ4 block to ``out``.  A match may
    reach back to ``floor`` (the block's own start where blocks are
    independent, 64 KiB before it where they are linked) and no further."""
    i, n = 0, len(src)
    while True:
        if i >= n:
            raise FrameError("block ends inside a sequence")
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise FrameError("literals run past the block")
        out += src[i:i + lit]
        i += lit
        if i == n:
            return                      # the last sequence has no match
        off = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 15) + 4
        if token & 15 == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - off
        if off == 0 or start < floor:
            raise FrameError(f"match offset {off} reaches before the "
                             "block's window")
        if off >= mlen:
            out += out[start:start + mlen]
        else:                           # overlapping: the pattern repeats
            pattern = out[start:]
            reps, rest = divmod(mlen, off)
            out += pattern * reps + pattern[:rest]


@dataclasses.dataclass
class Frame:
    flags: dict             # the frame's descriptor, in a configuration's keys
    content: bytes          # every block decoded
    checksum: int | None    # the stored content checksum


def read_frame(frame: bytes) -> Frame:
    """Parse and decode one modern frame, with nothing after it."""
    if len(frame) < 7 or struct.unpack_from("<I", frame)[0] != MAGIC:
        raise FrameError("not a modern LZ4 frame")
    flg, bd = frame[4], frame[5]
    if flg >> 6 != 1 or flg & 0x03 or bd & 0x8F:
        raise FrameError(f"reserved descriptor bits set (FLG {flg:#x}, "
                         f"BD {bd:#x})")
    flags = {"block_max_code": bd >> 4,
             "block_independence": bool(flg & 0x20),
             "block_checksum": bool(flg & 0x10),
             "content_size": bool(flg & 0x08),
             "content_checksum": bool(flg & 0x04)}
    pos = 6 + (8 if flags["content_size"] else 0)
    if flags["block_max_code"] not in BLOCK_SIZE:
        raise FrameError(f"block size code {flags['block_max_code']}")
    if (xxh32(frame[4:pos]) >> 8) & 0xFF != frame[pos]:
        raise FrameError("header checksum")
    pos += 1
    max_block = BLOCK_SIZE[flags["block_max_code"]]
    out = bytearray()
    while True:
        (size,) = struct.unpack_from("<I", frame, pos)
        pos += 4
        if size == 0:
            break
        stored, size = size >> 31, size & 0x7FFFFFFF
        if size > max_block or pos + size > len(frame):
            raise FrameError(f"block of {size} B")
        body = frame[pos:pos + size]
        pos += size
        if flags["block_checksum"]:
            (want,) = struct.unpack_from("<I", frame, pos)
            pos += 4
            if xxh32(body) != want:
                raise FrameError("block checksum")
        if stored:
            out += body
        else:
            floor = (len(out) if flags["block_independence"]
                     else max(0, len(out) - 65536))
            before = len(out)
            decode_block(body, out, floor)
            if len(out) - before > max_block:
                raise FrameError("a block decodes past the block size")
    checksum = None
    if flags["content_checksum"]:
        (checksum,) = struct.unpack_from("<I", frame, pos)
        pos += 4
    if pos != len(frame):
        raise FrameError(f"{len(frame) - pos} B after the frame")
    return Frame(flags, bytes(out), checksum)


def check_frame(frame: bytes, raw: np.ndarray, flags: dict, raw_xxh32: int
                ) -> dict:
    """Judge one encoded frame of ``raw``: counts of the ways it is wrong
    (each 0 or 1).  ``header``: its descriptor is not ``flags``;
    ``content``: it does not decode to ``raw`` (or does not decode);
    ``checksum``: its stored content checksum is not ``raw_xxh32``, or is
    missing where ``flags`` asks for one."""
    try:
        got = read_frame(frame)
    except (FrameError, IndexError, struct.error):
        return {"header": 0, "content": 1, "checksum": 0}
    bad_sum = flags["content_checksum"] and got.checksum != raw_xxh32
    return {"header": int(got.flags != {k: flags[k] for k in got.flags}),
            "content": int(got.content != raw.tobytes()),
            "checksum": int(bool(bad_sum))}


def decode_unverified(frame: bytes) -> bytes:
    """The frame's bytes with no checksum looked at: the reference with
    the configuration's content-checksum guarantee broken (the control
    of a decode cell)."""
    if len(frame) < 7 or struct.unpack_from("<I", frame)[0] != MAGIC:
        raise FrameError("not a modern LZ4 frame")
    flg, bd = frame[4], frame[5]
    pos = 7 + (8 if flg & 0x08 else 0)
    out = bytearray()
    while True:
        (size,) = struct.unpack_from("<I", frame, pos)
        pos += 4
        if size == 0:
            return bytes(out)
        stored, size = size >> 31, size & 0x7FFFFFFF
        body = frame[pos:pos + size]
        pos += size + (4 if flg & 0x10 else 0)
        if stored:
            out += body
        else:
            decode_block(body, out, len(out) if flg & 0x20
                         else max(0, len(out) - 65536))
