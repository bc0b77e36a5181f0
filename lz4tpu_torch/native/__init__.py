"""Loader for the native host engine (lz4core.cpp).

Compiles the shared library on first use with g++ (cached next to the
source), binds it via ctypes. Everything here has a pure-Python fallback
elsewhere in the package; callers use :func:`available` to pick.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "lz4core.cpp")
_SO = os.path.join(_HERE, "_lz4core.so")

_lock = threading.Lock()
_lib = None
_load_error: Exception | None = None

OK = 0
E_OFFSET_ZERO = 1
E_BACKREF_RANGE = 2
E_MATCH_AFTER_LIT = 3
E_TRUNCATED = 4
E_DST_OVERFLOW = 5
E_SEQ_OVERFLOW = 6


def _build() -> None:
    with tempfile.TemporaryDirectory(dir=_HERE) as td:
        tmp_so = os.path.join(td, "_lz4core.so")
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-funroll-loops", "-shared",
                "-fPIC", "-std=c++17", "-pthread", "-o", tmp_so, _SRC,
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp_so, _SO)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    i64p = c.POINTER(c.c_int64)
    i32p = c.POINTER(c.c_int32)

    lib.lz4tpu_xxh32.restype = c.c_uint32
    lib.lz4tpu_xxh32.argtypes = [u8p, c.c_int64, c.c_uint32]
    lib.lz4tpu_xxh32_state_size.restype = c.c_int32
    lib.lz4tpu_xxh32_init.argtypes = [c.c_void_p, c.c_uint32]
    lib.lz4tpu_xxh32_update.argtypes = [c.c_void_p, u8p, c.c_int64]
    lib.lz4tpu_xxh32_final.restype = c.c_uint32
    lib.lz4tpu_xxh32_final.argtypes = [c.c_void_p]

    lib.lz4tpu_decode_block_ring.restype = c.c_int32
    lib.lz4tpu_decode_block_ring.argtypes = [
        u8p, c.c_int64, u8p, c.c_int64, c.c_int64, c.c_int64, i64p, i64p,
    ]
    lib.lz4tpu_scan_sequences.restype = c.c_int64
    lib.lz4tpu_scan_sequences.argtypes = [
        u8p, c.c_int64, c.c_int64, c.c_int64,
        i32p, i32p, i32p, i32p, i32p, c.c_int64, i64p, i64p,
    ]
    lib.lz4tpu_compress_block.restype = c.c_int64
    lib.lz4tpu_compress_block.argtypes = [
        u8p, c.c_int64, u8p, c.c_int64, u8p, c.c_int64, c.c_int32,
        c.c_int32,
    ]
    lib.lz4tpu_compress_block_opt.restype = c.c_int64
    lib.lz4tpu_compress_block_opt.argtypes = [
        u8p, c.c_int64, u8p, c.c_int64, u8p, c.c_int64, c.c_int32,
    ]
    lib.lz4tpu_compress_block_cands.restype = c.c_int64
    lib.lz4tpu_compress_block_cands.argtypes = [
        u8p, c.c_int64, c.c_int64, i32p, c.c_int32, u8p, c.c_int64,
        c.c_int32,
    ]
    lib.lz4tpu_emit_quantized.restype = c.c_int64
    lib.lz4tpu_emit_quantized.argtypes = [
        u8p, c.c_int64, c.c_int64,               # buf, hist_len, src_len
        c.POINTER(c.c_uint16), c.POINTER(c.c_uint16),  # elen, eoff
        u8p, c.c_int64,                           # dst, cap
    ]
    lib.lz4tpu_pack_dense2.restype = c.c_int64
    lib.lz4tpu_pack_dense2.argtypes = [
        u8p, c.c_int64, i32p, i32p, i32p, i32p, c.c_int64, i32p, c.c_int64,
    ]
    lib.lz4tpu_pack_dense2_par.restype = c.c_int64
    lib.lz4tpu_pack_dense2_par.argtypes = [
        u8p, c.c_int64, i32p, i32p, i32p, i32p, c.c_int64, i32p, c.c_int64,
        c.c_int32,
    ]
    lib.lz4tpu_prep_fused.restype = c.c_int32
    lib.lz4tpu_prep_fused.argtypes = [
        i32p, i32p, i32p, i32p, c.c_int64,       # ll, ml, mo, ls, S
        u8p, c.c_int64,                           # buf, buf_len
        c.c_int64, c.c_int64,                     # lit_base, n_win
        u8p, c.c_int64,                           # lits, lit_cap
        i32p, i32p, i32p, i32p,                   # winq, scal,
        i32p,                                     # seqrec, patch, hw
        i64p,                                     # counts
        c.c_int32,                                # n_threads
    ]
    lib.lz4tpu_scan_block_full.restype = c.c_int64
    lib.lz4tpu_scan_block_full.argtypes = [
        u8p, c.c_int64, c.c_int64,                # src, src_len, lit_base
        i32p, i32p, i32p, i32p, i32p, i32p,       # cols (+litpos)
        u8p, c.c_int64,                           # lits, lits_cap
        c.c_int64, i64p, i64p, i64p, i64p,        # cap, total, reach,
                                                  # n_lit, max_off
    ]
    lib.lz4tpu_prep_last_ranges.restype = c.c_int64
    lib.lz4tpu_prep_last_ranges.argtypes = [i64p, c.c_int64]
    lib.lz4tpu_resolve_window.restype = c.c_int32
    lib.lz4tpu_resolve_window.argtypes = [
        i32p, i32p, i32p, i32p, c.c_int64,        # ll, ml, mo, ls, S
        u8p,                                       # buf
        i32p,                                      # starts [S+1]
        c.c_int64, c.c_int64,                      # B, W
        u8p,                                       # out [W]
        c.c_int64,                                 # hop budget
    ]
    lib.lz4tpu_prep_fused_pre.restype = c.c_int32
    lib.lz4tpu_prep_fused_pre.argtypes = [
        i32p, i32p, i32p, i32p, c.c_int64,       # ll, ml, mo, ls, S
        u8p,                                      # buf
        c.c_int64,                                # n_win
        i32p, i32p,                               # starts, litpos (S+2)
        u8p, c.c_int64,                           # lits, n_out
        i32p, i32p, i32p, i32p,                   # winq, scal, seqrec, patch
        i32p,                                     # hw
        i64p,                                     # counts
        c.c_int32,                                # n_threads
    ]
    return lib


def _get() -> ctypes.CDLL:
    global _lib, _load_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error is not None:
            raise _load_error
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                _build()
            _lib = _bind(ctypes.CDLL(_SO))
        except Exception as exc:  # pragma: no cover - environment dependent
            _load_error = exc
            raise
    return _lib


def available() -> bool:
    """True if the native engine can be loaded (builds it if needed)."""
    try:
        _get()
        return True
    except Exception:
        return False


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray) and data.dtype == np.uint8 and data.flags.c_contiguous:
        return data
    return np.frombuffer(bytes(data), dtype=np.uint8)


def native_xxh32(data, seed: int = 0) -> int:
    arr = _as_u8(data)
    return int(_get().lz4tpu_xxh32(_u8ptr(arr), arr.size, seed & 0xFFFFFFFF))


class NativeXXH32:
    """Streaming xxh32 backed by the native engine (same API as XXHash32)."""

    __slots__ = ("_state",)

    def __init__(self, seed: int = 0) -> None:
        lib = _get()
        self._state = ctypes.create_string_buffer(lib.lz4tpu_xxh32_state_size())
        lib.lz4tpu_xxh32_init(self._state, seed & 0xFFFFFFFF)

    def reset(self, seed: int = 0) -> None:
        _get().lz4tpu_xxh32_init(self._state, seed & 0xFFFFFFFF)

    def update(self, data) -> "NativeXXH32":
        arr = _as_u8(data)
        if arr.size:
            _get().lz4tpu_xxh32_update(self._state, _u8ptr(arr), arr.size)
        return self

    def final(self) -> int:
        return int(_get().lz4tpu_xxh32_final(self._state))


def decode_block_ring(
    src, buf: np.ndarray, out_pos: int, out_pos_history: int
) -> tuple[int, int, int]:
    """Decode one raw block into the ring buffer.

    Returns (status, new_out_pos, err_detail). Status 0 = OK.
    """
    arr = _as_u8(src)
    new_pos = ctypes.c_int64(0)
    err_a = ctypes.c_int64(0)
    st = _get().lz4tpu_decode_block_ring(
        _u8ptr(arr), arr.size, _u8ptr(buf), buf.size,
        out_pos, out_pos_history,
        ctypes.byref(new_pos), ctypes.byref(err_a),
    )
    return int(st), int(new_pos.value), int(err_a.value)


_scan_arena = threading.local()


def scan_sequences(
    src, lit_base: int = 0, out_base: int = 0, pooled: bool = False
) -> tuple[int, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, int, int]:
    """Token-scan a raw block into a structure-of-arrays sequence table.

    Returns (status, out_start, lit_len, lit_src, match_len, match_off,
    total_out, min_reach).  Status 0 = OK, otherwise one of the E_*
    codes.  `lit_base` offsets lit_src (the block's position inside the
    whole stream); `out_base` offsets out_start (the block's global
    output position); `min_reach` is the lowest global output position
    any back-reference touches (2**63-1 when the block has no matches).

    ``pooled=True`` returns views into per-thread grow-only scratch
    (warm pages — fresh multi-MB np.empty costs ~1 ms of first-touch
    faults per request): the views are INVALIDATED by this thread's
    next pooled scan, so the caller must copy before then
    (build_seq_table's column concatenation is that copy).
    """
    arr = _as_u8(src)
    # Worst case: one sequence per input byte (token-only degenerate) —
    # in valid streams a sequence is >= 2 bytes except the last; +8 slack.
    cap = arr.size + 8
    if pooled:
        bufs = getattr(_scan_arena, "bufs", None)
        if bufs is None or bufs[0].size < cap:
            cap_r = max(1 << 16, 1 << (cap - 1).bit_length())
            bufs = tuple(np.empty(cap_r, np.int32) for _ in range(5))
            _scan_arena.bufs = bufs
        out_start, lit_len, lit_src, match_len, match_off = bufs
    else:
        out_start = np.empty(cap, dtype=np.int32)
        lit_len = np.empty(cap, dtype=np.int32)
        lit_src = np.empty(cap, dtype=np.int32)
        match_len = np.empty(cap, dtype=np.int32)
        match_off = np.empty(cap, dtype=np.int32)
    total = ctypes.c_int64(0)
    reach = ctypes.c_int64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = _get().lz4tpu_scan_sequences(
        _u8ptr(arr), arr.size, lit_base, out_base,
        out_start.ctypes.data_as(i32p),
        lit_len.ctypes.data_as(i32p), lit_src.ctypes.data_as(i32p),
        match_len.ctypes.data_as(i32p), match_off.ctypes.data_as(i32p),
        out_start.size, ctypes.byref(total), ctypes.byref(reach),
    )
    if n < 0:
        z = lit_len[:0]
        return int(-n), z, z, z, z, z, 0, 0
    return (
        OK,
        out_start[:n], lit_len[:n], lit_src[:n], match_len[:n],
        match_off[:n], int(total.value), int(reach.value),
    )


def prep_last_ranges() -> np.ndarray:
    """Per-range instrumentation of the LAST lz4tpu_prep_fused[_pre]
    call: (n, 4) int64 rows [sub_lo, sub_hi, n_records, n_patches].

    Rows are recorded only while LZ4TPU_PREP_COUNTERS=1 (a test hook:
    tests/test_prep_threads.py pins that the threaded prep's range
    partitioning genuinely divides the serial loop — phase counters,
    not wall time, per the one-core box's measurement rules).  The
    serial pass records a single row spanning every substep."""
    c = ctypes
    buf = np.zeros((256, 4), np.int64)
    n = _get().lz4tpu_prep_last_ranges(
        buf.ctypes.data_as(c.POINTER(c.c_int64)), 256
    )
    return buf[:n]


def resolve_window(
    lit_len: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    lit_src: np.ndarray,
    buf: np.ndarray,
    starts: np.ndarray,
    boundary: int,
    nbytes: int,
    out: np.ndarray | None = None,
    hop_budget: int = 1 << 24,
) -> np.ndarray:
    """Chain output bytes [boundary - nbytes, boundary) materialized by
    provenance chain-following (lz4tpu_resolve_window) — the boundary
    ring seed of span-parallel decode (lz4tpu_torch/spans.py).  ``starts`` is
    the int32 [S+1] chain-local size prefix.  Bit-identical to
    spans.resolve_ring_bytes (differential-tested).  Raises ValueError
    when a chain walk exceeds the native depth cap (callers fall back
    to the numpy resolver or skip span-splitting)."""
    c = ctypes
    i32p = c.POINTER(c.c_int32)
    if out is None:
        out = np.empty(nbytes, np.uint8)
    st = _get().lz4tpu_resolve_window(
        lit_len.ctypes.data_as(i32p), match_len.ctypes.data_as(i32p),
        match_off.ctypes.data_as(i32p), lit_src.ctypes.data_as(i32p),
        lit_len.size, _u8ptr(buf), starts.ctypes.data_as(i32p),
        boundary, nbytes, _u8ptr(out), hop_budget,
    )
    if st != 0:
        raise ValueError(f"resolve_window failed with status {st}")
    return out


def pack_threads() -> int:
    """Worker threads for the host-parallel stages (per-block token
    scan, the fused prep, the mxu2 pack and the provenance resolver):
    the LZ4TPU_PACK_THREADS env var when it parses as a positive
    integer, else 1.

    One by default: on an 8-core H100 host, the host prep (scan and
    plan) of 336 frames of 64 KiB blocks took 1.4-1.8 s on one thread
    and 4.1-6.4 s on eight, with ten times the system CPU, and the
    eight-thread time varied more between processes; 64 MiB of zeros
    in 4 MiB blocks prepared faster on one thread too.  The work items
    are small beside a thread's hand-off cost."""
    import os

    env = os.environ.get("LZ4TPU_PACK_THREADS")
    if env:
        try:
            return max(1, int(env.strip()))
        except ValueError:
            pass  # a tuning knob must not take down the decode path
    return 1


def pack_dense2_chain(
    buf: np.ndarray,
    lit_len: np.ndarray,
    lit_src: np.ndarray,
    match_len: np.ndarray,
    match_off: np.ndarray,
    out: np.ndarray | None = None,
    threads: int | None = None,
) -> tuple[np.ndarray, int]:
    """Per-byte provenance codes for one chain (device/mxu2.py pack).

    Returns (code int32 [n_out], n_out); bit-identical to the numpy
    resolver in mxu2._pack_chain (asserted by tests).  When `out` is
    given, codes are written in place into it (it must be contiguous
    int32 with >= n_out + 16 elements; the resolver wild-writes up to
    16 words past n_out and re-zeroes them) and the returned array is
    a view of out.  `threads` > 1 packs substep-aligned ranges in
    parallel (bit-identical; default from pack_threads()).
    """
    c = ctypes
    i32p = c.POINTER(c.c_int32)
    n_out = int(np.sum(lit_len, dtype=np.int64)
                + np.sum(match_len, dtype=np.int64))
    if out is None:
        code = np.zeros(n_out + 16, np.int32)
    else:
        code = out
        if code.size < n_out + 16:
            raise ValueError("pack_dense2 out buffer too small")
    n_threads = pack_threads() if threads is None else max(1, threads)
    n = _get().lz4tpu_pack_dense2_par(
        _u8ptr(buf), buf.size,
        lit_len.ctypes.data_as(i32p), lit_src.ctypes.data_as(i32p),
        match_len.ctypes.data_as(i32p), match_off.ctypes.data_as(i32p),
        lit_len.size, code.ctypes.data_as(i32p), code.size, n_threads,
    )
    if n < 0:
        raise ValueError(f"pack_dense2 failed with status {-n}")
    return code[:n], int(n)


def compress_block_cands(
    joined: np.ndarray, hist_len: int, src_len: int,
    cand: np.ndarray, lazy: bool = True,
) -> bytes:
    """Emit an LZ4 block from device-generated match candidates.
    ``cand`` is (k, n) — the k nearest previous same-gram positions per
    position — or (n,) for depth 1."""
    c = ctypes
    cap = src_len + src_len // 128 + 64
    dst = np.empty(cap, np.uint8)
    cand = np.ascontiguousarray(cand, np.int32)
    if cand.ndim == 1:
        cand = cand.reshape(1, -1)
    if cand.shape[1] != hist_len + src_len:
        raise ValueError("cand must cover the joined buffer")
    n = _get().lz4tpu_compress_block_cands(
        _u8ptr(joined), hist_len, src_len,
        cand.ctypes.data_as(c.POINTER(c.c_int32)), cand.shape[0],
        _u8ptr(dst), cap, int(lazy),
    )
    if n < 0:
        raise RuntimeError("compress_block_cands: destination overflow")
    return dst[:n].tobytes()


def emit_quantized(joined: np.ndarray, hist_len: int, src_len: int,
                   elen: np.ndarray, eoff: np.ndarray) -> bytes:
    """Mechanical token splice for the device-emission prototype: the
    device decided every match (quantized length + offset, guaranteed
    correct by the gram sorts); this walk formats the token stream,
    merges same-offset runs arithmetically, and extends matches
    forward while bytes agree (the only byte compares — each advances
    the cursor, so O(block) total).  No searching."""
    c = ctypes
    cap = src_len + src_len // 128 + 64 + src_len // 8
    dst = np.empty(cap, np.uint8)
    assert elen.dtype == np.uint16 and eoff.dtype == np.uint16
    n = _get().lz4tpu_emit_quantized(
        _u8ptr(joined), c.c_int64(hist_len), c.c_int64(src_len),
        elen.ctypes.data_as(c.POINTER(c.c_uint16)),
        eoff.ctypes.data_as(c.POINTER(c.c_uint16)),
        _u8ptr(dst), c.c_int64(cap),
    )
    if n < 0:
        raise RuntimeError("emit_quantized: destination overflow")
    return dst[:n].tobytes()


def compress_block(
    src, hist: bytes = b"", max_chain: int = 64, optimal: bool = False,
    lazy: bool = True,
) -> bytes:
    """LZ4 block compression: hash-chain matcher (with skip
    acceleration; ``lazy`` enables one-step deferred matching for
    ratio), or the exact backward-DP optimal parse when ``optimal``
    (slower, best ratio)."""
    src_b = bytes(src)
    if not src_b:
        return b""
    if hist:
        joined = np.frombuffer(hist[-65536:] + src_b, dtype=np.uint8)
        hist_len = min(len(hist), 65536)
    else:
        joined = np.frombuffer(src_b, dtype=np.uint8)
        hist_len = 0
    cap = len(src_b) + len(src_b) // 128 + 64
    dst = np.empty(cap, dtype=np.uint8)
    src_ptr = _u8ptr(joined[hist_len:]) if hist_len else _u8ptr(joined)
    if optimal:
        n = _get().lz4tpu_compress_block_opt(
            _u8ptr(joined), hist_len, src_ptr, len(src_b),
            _u8ptr(dst), cap, max_chain,
        )
    else:
        n = _get().lz4tpu_compress_block(
            _u8ptr(joined), hist_len, src_ptr, len(src_b),
            _u8ptr(dst), cap, max_chain, 1 if lazy else 0,
        )
    if n < 0:
        raise RuntimeError("lz4tpu_compress_block: destination overflow")
    return dst[:n].tobytes()


_PREP_OVERFLOW = {
    -10: "seq records per substep (budget)",
    -11: "in-substep patches (budget)",
    -12: "field delta exceeds digit range",
    -13: "patch literal outside window",
    -14: "patch chain deeper than 64",
    -15: "literal affine constant range",
    -16: "match spans cross >64 substeps",
}


_scan_full_arena = threading.local()


def scan_block_full(src, comp_off: int = 0):
    """Single-block full scan: the token scan plus, in the same native
    pass, the cumulative literal-position column, the flat extracted
    literal stream, and the S/S+1 sentinel slots the fused prep's
    bisects need (lz4core.cpp lz4tpu_scan_block_full).

    Returns ``(status, starts_ext, ll, ls, ml, mo, litpos_ext, lits,
    total, min_reach, max_off)`` where ``starts_ext``/``litpos_ext``
    are ``(n+2)``-long (sentinels included), the other columns
    ``n``-long, and ``lits`` holds the first ``litpos_ext[n]`` literal
    bytes.

    All arrays are views into per-thread grow-only scratch, INVALIDATED
    by this thread's next scan_block_full call — the request pipeline
    consumes a table fully before scanning the next request."""
    arr = _as_u8(src)
    cap = arr.size + 8
    a = getattr(_scan_full_arena, "bufs", None)
    if a is None or a[0].size < cap + 2 or a[6].size < arr.size + 16:
        cap_r = max(1 << 16, 1 << (cap + 2 - 1).bit_length())
        lit_r = max(1 << 16, 1 << (arr.size + 16 - 1).bit_length())
        a = tuple(np.empty(cap_r, np.int32) for _ in range(6)) + (
            np.empty(lit_r, np.uint8),)
        _scan_full_arena.bufs = a
    starts, ll, ls, ml, mo, litpos, lits = a
    total = ctypes.c_int64(0)
    reach = ctypes.c_int64(0)
    n_lit = ctypes.c_int64(0)
    moff = ctypes.c_int64(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = _get().lz4tpu_scan_block_full(
        _u8ptr(arr), arr.size, comp_off,
        starts.ctypes.data_as(i32p), ll.ctypes.data_as(i32p),
        ls.ctypes.data_as(i32p), ml.ctypes.data_as(i32p),
        mo.ctypes.data_as(i32p), litpos.ctypes.data_as(i32p),
        _u8ptr(lits), lits.size,
        starts.size - 2, ctypes.byref(total), ctypes.byref(reach),
        ctypes.byref(n_lit), ctypes.byref(moff),
    )
    if n < 0:
        z = ll[:0]
        return int(n), z, z, z, z, z, z, lits[:0], 0, 0, 1
    return (OK, starts[:n + 2], ll[:n], ls[:n], ml[:n], mo[:n],
            litpos[:n + 2], lits[:int(n_lit.value)],
            int(total.value), int(reach.value), int(moff.value))


def prep_fused_chain_pre(ll, ml, mo, ls, buf, n_win, starts, litpos,
                         lits, n_out, winq, scal, seqrec, patch,
                         hw=None, n_threads=None):
    """Native fused prep from scan_block_full outputs (phase 1 —
    prefix sums + literal extraction — already done at scan time).

    ``hw`` is the pool's per-substep [n_sub, 2] int32 dirty high-water
    array (carried with the seqrec/patch buffers): tail zeroing stops
    at the previous request's counts instead of the slot capacity."""
    c = ctypes
    i32p = c.POINTER(c.c_int32)

    def ip(a):
        assert a.dtype == np.int32 and a.flags.c_contiguous
        return a.ctypes.data_as(i32p)

    counts = np.zeros(4, np.int64)
    buf8 = _as_u8(buf)
    st = _get().lz4tpu_prep_fused_pre(
        ip(ll), ip(ml), ip(mo), ip(ls), c.c_int64(ll.size),
        _u8ptr(buf8), c.c_int64(n_win),
        ip(starts), ip(litpos),
        _u8ptr(lits), c.c_int64(n_out),
        ip(winq), ip(scal), ip(seqrec), ip(patch),
        ip(hw) if hw is not None else i32p(),
        counts.ctypes.data_as(c.POINTER(c.c_int64)),
        c.c_int32(n_threads if n_threads is not None
                  else pack_threads()),
    )
    if st != 0:
        raise ValueError(_PREP_OVERFLOW.get(st, f"prep status {st}"))
    return (int(counts[0]), int(counts[1]),
            int(counts[2]), int(counts[3]))


def prep_fused_chain(ll, ml, mo, ls, buf, lit_base, n_win,
                     lits, winq, scal, seqrec, patch, hw=None,
                     n_threads=None):
    """Native fused-engine prep for one chain (device/fused.py layout).

    Writes into the caller's zeroed per-chain array views; returns
    (n_seq_recs, n_patches).  Raises ValueError with an overflow
    message (the fused module wraps it in FusedOverflow)."""
    c = ctypes
    i32p = c.POINTER(c.c_int32)

    def ip(a):
        assert a.dtype == np.int32 and a.flags.c_contiguous
        return a.ctypes.data_as(i32p)

    counts = np.zeros(4, np.int64)
    buf8 = _as_u8(buf)
    st = _get().lz4tpu_prep_fused(
        ip(ll), ip(ml), ip(mo), ip(ls), c.c_int64(ll.size),
        _u8ptr(buf8), c.c_int64(buf8.size),
        c.c_int64(lit_base), c.c_int64(n_win),
        _u8ptr(lits), c.c_int64(lits.size),
        ip(winq), ip(scal), ip(seqrec), ip(patch),
        ip(hw) if hw is not None else i32p(),
        counts.ctypes.data_as(c.POINTER(c.c_int64)),
        c.c_int32(n_threads if n_threads is not None
                  else pack_threads()),
    )
    if st != 0:
        raise ValueError(_PREP_OVERFLOW.get(st, f"prep status {st}"))
    return (int(counts[0]), int(counts[1]),
            int(counts[2]), int(counts[3]))
