"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one compiler process per source and all started together,
and linked into one shared library with a plain C interface, cached
in the package's own ``_build/`` directory, one cache per tree, in a
checkout and in an installed tree alike (override with
``LZ4TPU_TORCH_BUILD``), and rebuilt when a source is newer.  The cache
stays out of a checkout's ``build/``, which setuptools uses as scratch
and packaging removes.  The library is bound with ``ctypes``: every
pointer and the stream are ``c_void_p``.
Each C entry returns ``cudaGetLastError()`` after its launch; the
launch helpers here raise on a nonzero status and only then count the
launch in :data:`LAUNCHES`.

Nothing here runs at import time, so the CPU tests can import every
module of the port on a machine with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(os.environ.get("LZ4TPU_TORCH_BUILD",
                                        CSRC.parent / "_build"))
LIB_NAME = "liblz4tpu_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: Launches per kernel since the last :func:`reset_launches`.
LAUNCHES = {"fused_expand": 0, "fused_route": 0, "mxu2_route": 0,
            "block_fill": 0, "xxh32_stream": 0, "xxh32_blocks": 0,
            "segment_decode": 0, "mxu2_route_ab": 0}

_lock = threading.Lock()    # guards the library handle and LAUNCHES
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_SIGNATURES = {
    "lz4t_block_fill": [_P, _I64, _P, _P],
    "lz4t_fused_expand": [_P, _P, _P, _P, _I64, _P],
    "lz4t_fused_route": [_P, _P, _P, _P, _P, _I32, _P, _P, _P, _P],
    "lz4t_mxu2_route": [_P, _P, _P, _I32, _P, _P, _P, _I32, _I32, _P, _P],
    "lz4t_xxh32_stream": [_P, _I64, _P, _P, _P],
    "lz4t_xxh32_blocks": [_P, _P, _P, _I32, _P, _P],
    "lz4t_segment_decode": [_P, _P, _I64, _P, _I32, _P, _I32, _P],
    "lz4t_mxu2_route_ab": [_P, _I32, _I32, _I32, _P, _P, _P, _I32, _P, _P],
}


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "lz4tpu_torch: nvcc not found (PATH, CUDA_HOME or "
            "/usr/local/cuda); the CUDA kernels cannot be built")
    return path


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` into the cached shared library if it is
    missing or older than a source; returns its path.  Each source is
    compiled to an object by its own ``nvcc`` process, all running at
    once, then one link.  The compilers' output, ``-Xptxas -v`` register
    and shared-memory report included, is kept in ``nvcc.log`` beside
    the library."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in [*sources, *CSRC.glob("*.cuh")])
    so = BUILD_DIR / LIB_NAME
    if so.exists() and so.stat().st_mtime >= newest:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(p)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p, o in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    try:
        failed = [(p, lg) for p, proc, lg in zip(sources, procs, logs)
                  if proc.returncode != 0]
        if not failed:
            r = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True, check=False)
            logs.append(r.stdout + r.stderr)
            if r.returncode != 0:
                failed = [(so, logs[-1])]
        (BUILD_DIR / "nvcc.log").write_text("".join(logs))
        if failed:
            raise RuntimeError(
                f"lz4tpu_torch: nvcc failed on {failed[0][0].name}:\n"
                f"{failed[0][1][-4000:]}")
        os.replace(tmp, so)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return so


def lib() -> ctypes.CDLL:
    """The bound kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.lz4t_error_string.restype = ctypes.c_char_p
            handle.lz4t_error_string.argtypes = [_I32]
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = _I32
                fn.argtypes = argtypes
            _lib = handle
        return _lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple, align: int = 16) -> None:
    """Validate a kernel argument: CUDA, dtype, shape, contiguous and
    aligned (16 bytes for arrays the kernels move as 16-byte vectors)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(
            f"{name} must be contiguous and {align}-byte aligned")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry ``entry`` on ``device``'s current stream (appended
    as the last argument); raise on a nonzero status, else count one
    launch of ``kernel``."""
    fn = getattr(lib(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = fn(*args, stream)
    if status != 0:
        msg = lib().lz4t_error_string(status).decode()
        raise RuntimeError(
            f"lz4tpu_torch: {entry} launch failed: {msg} ({status})")
    with _lock:
        LAUNCHES[kernel] += 1
