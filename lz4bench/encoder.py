"""The benchmark's frozen LZ4 frame encoder.

``frozen/lz4enc.cpp`` is a copy of the program's hash-chain block
encoder and xxhash32 as they stood when the benchmark was defined.  It
is built with ``g++`` into ``lz4bench/_build/`` (a fixed directory in
the checkout, rebuilt only when the source is newer) and bound with
``ctypes``.  :func:`compress_frame` writes a modern LZ4 frame with it,
byte for byte as the program's ``compress`` wrote one at that time, so
the decode cells' inputs do not move when the program's encoder does.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import pathlib
import struct
import subprocess
import threading

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
SOURCE = HERE / "frozen" / "lz4enc.cpp"
BUILD_DIR = HERE / "_build"
LIBRARY = BUILD_DIR / "lz4enc.so"

MAGIC = 0x184D2204
BLOCK_SIZE = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}
WINDOW = 65536
#: Chain depth and lazy matching of each compression level, as the
#: program's ``compress`` mapped them: 1-3 shallow chains without lazy
#: deferral, 4-9 the full lazy chain.
MAX_CHAIN = 64

_lock = threading.Lock()
_lib = None


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lz4enc.so.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, LIBRARY)


def lib() -> ctypes.CDLL:
    """The built library, built first where it is missing or older than
    its source."""
    global _lib
    with _lock:
        if _lib is None:
            if (not LIBRARY.exists()
                    or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime):
                _build()
            so = ctypes.CDLL(str(LIBRARY))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            so.lz4bench_xxh32.restype = ctypes.c_uint32
            so.lz4bench_xxh32.argtypes = [p, i64, ctypes.c_uint32]
            so.lz4bench_compress_block.restype = i64
            so.lz4bench_compress_block.argtypes = [p, i64, p, i64, p, i64,
                                                   i32, i32]
            _lib = so
    return _lib


def xxh32(data: np.ndarray, seed: int = 0) -> int:
    data = np.ascontiguousarray(data, np.uint8)
    return int(lib().lz4bench_xxh32(data.ctypes.data, data.size, seed))


def _block(data: np.ndarray, pos: int, n: int, linked: bool, max_chain: int,
           lazy: bool) -> np.ndarray:
    """One compressed block of ``data[pos:pos + n]`` (its 64 KiB before it
    as history where blocks are linked), or an empty array where it
    does not shrink."""
    hist = min(pos, WINDOW) if linked else 0
    cap = n + n // 128 + 64
    dst = np.empty(cap, np.uint8)
    base = data.ctypes.data
    got = lib().lz4bench_compress_block(
        base + pos - hist, hist, base + pos, n, dst.ctypes.data, cap,
        max_chain, int(lazy))
    if got < 0:
        raise RuntimeError("frozen encoder: destination overflow")
    return dst[:got]


def descriptor(flags: dict) -> bytes:
    """The frame descriptor (FLG, BD, HC) of a configuration's frame
    flags; no content size."""
    if flags["content_size"]:
        raise ValueError("the frozen encoder writes no content size")
    flg = (1 << 6) | (0x20 if flags["block_independence"] else 0)
    if flags["block_checksum"]:
        flg |= 0x10
    if flags["content_checksum"]:
        flg |= 0x04
    body = bytes([flg, flags["block_max_code"] << 4])
    hc = (xxh32(np.frombuffer(body, np.uint8)) >> 8) & 0xFF
    return body + bytes([hc])


def compress_frame(raw: np.ndarray, flags: dict, level: int,
                   workers: int = 8) -> bytes:
    """A modern LZ4 frame of ``raw`` under ``flags`` (the configuration's
    ``frame``) at ``level``.  Every block depends on the input alone (a
    linked block's history is the input before it), so the blocks are
    compressed on ``workers`` threads; the frame does not depend on
    their number."""
    raw = np.ascontiguousarray(raw, np.uint8)
    size = BLOCK_SIZE[flags["block_max_code"]]
    linked = not flags["block_independence"]
    max_chain = min(MAX_CHAIN, 8) if level <= 3 else MAX_CHAIN
    lazy = level >= 4
    if level >= 10:
        raise ValueError("the frozen encoder has no optimal parser (level "
                         ">= 10)")
    starts = range(0, raw.size, size)
    with concurrent.futures.ThreadPoolExecutor(max(1, workers)) as pool:
        blocks = list(pool.map(
            lambda pos: _block(raw, pos, min(size, raw.size - pos), linked,
                               max_chain, lazy), starts))
    out = [struct.pack("<I", MAGIC), descriptor(flags)]
    for pos, comp in zip(starts, blocks):
        chunk = raw[pos:pos + size]
        if comp.size and comp.size < chunk.size:
            body = comp
            out.append(struct.pack("<I", comp.size))
        else:
            body = chunk
            out.append(struct.pack("<I", chunk.size | 0x80000000))
        out.append(body.tobytes())
        if flags["block_checksum"]:
            out.append(struct.pack("<I", xxh32(body)))
    out.append(b"\x00\x00\x00\x00")
    if flags["content_checksum"]:
        out.append(struct.pack("<I", xxh32(raw)))
    return b"".join(out)
