"""Streaming XXHash32, bit-exact with the reference implementation.

Reference behavior: lib/lz4ada.adb:923-1026 (spec lib/lz4ada.ads:311-344):
4 u32 lane accumulators fed 16-byte stripes, a 16-byte carry buffer,
re-finalizable at any point, resettable.

This pure-Python implementation is the portable fallback and the oracle
for the native (C++) and Pallas versions; the hot paths use those.
"""

from __future__ import annotations

import struct

__all__ = ["XXHash32", "xxh32"]

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(v: int, r: int) -> int:
    v &= _M32
    return ((v << r) | (v >> (32 - r))) & _M32


class XXHash32:
    """Incremental xxhash32 with the classic 4-lane state.

    ``final()`` does not mutate state: it may be called mid-stream and
    hashing can continue afterwards, matching the reference semantics
    (reference: README.md:717-734).
    """

    __slots__ = ("_s0", "_s1", "_s2", "_s3", "_buf", "_total")

    def __init__(self, seed: int = 0) -> None:
        self.reset(seed)

    def reset(self, seed: int = 0) -> None:
        self._s0 = (seed + _P1 + _P2) & _M32
        self._s1 = (seed + _P2) & _M32
        self._s2 = seed & _M32
        self._s3 = (seed - _P1) & _M32
        self._buf = b""
        self._total = 0

    def update(self, data) -> "XXHash32":
        data = bytes(data)
        self._total += len(data)
        buf = self._buf + data
        n_stripes = len(buf) // 16
        if n_stripes:
            s0, s1, s2, s3 = self._s0, self._s1, self._s2, self._s3
            words = struct.unpack_from(f"<{n_stripes * 4}I", buf)
            for i in range(0, n_stripes * 4, 4):
                s0 = (_rotl(s0 + words[i] * _P2, 13) * _P1) & _M32
                s1 = (_rotl(s1 + words[i + 1] * _P2, 13) * _P1) & _M32
                s2 = (_rotl(s2 + words[i + 2] * _P2, 13) * _P1) & _M32
                s3 = (_rotl(s3 + words[i + 3] * _P2, 13) * _P1) & _M32
            self._s0, self._s1, self._s2, self._s3 = s0, s1, s2, s3
        self._buf = buf[n_stripes * 16:]
        return self

    def final(self) -> int:
        if self._total >= 16:
            h = (
                _rotl(self._s0, 1)
                + _rotl(self._s1, 7)
                + _rotl(self._s2, 12)
                + _rotl(self._s3, 18)
            ) & _M32
        else:
            h = (self._s2 + _P5) & _M32
        h = (h + self._total) & _M32
        buf = self._buf
        i = 0
        while i + 4 <= len(buf):
            (w,) = struct.unpack_from("<I", buf, i)
            h = (_rotl(h + w * _P3, 17) * _P4) & _M32
            i += 4
        while i < len(buf):
            h = (_rotl(h + buf[i] * _P5, 11) * _P1) & _M32
            i += 1
        h ^= h >> 15
        h = (h * _P2) & _M32
        h ^= h >> 13
        h = (h * _P3) & _M32
        h ^= h >> 16
        return h


def xxh32(data, seed: int = 0) -> int:
    """One-shot xxhash32. Prefers the native engine for large inputs."""
    if len(data) >= 4096:
        try:
            from .native import native_xxh32

            return native_xxh32(data, seed)
        except Exception:
            pass
    return XXHash32(seed).update(data).final()
