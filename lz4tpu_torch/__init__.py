"""lz4tpu_torch — the lz4tpu LZ4 codec on PyTorch and CUDA (Hopper).

A port of ``lz4tpu`` beside it, and a package of its own: it imports
``torch`` and numpy, never JAX and nothing of ``lz4tpu``.  What it needs
of the host layer (frame parse, streaming engine, the native C++ engine,
xxh32, the encoder) it carries as its own copies under the same module
names, so its exception classes are its own too, with ``lz4tpu``'s
names and messages.

The device side covers the batched decode (:func:`decompress_to_device`,
:func:`decompress_device`, ``decompress(backend="device")``) with its
engines (sparse programs, the fused kernel, the mxu2 kernel, the
segment-copy kernel, the byte-parallel resolver), checksum
verification on the device (``verify="device"``), the request pipeline
(:class:`DecodeSession`: a prep thread with its own CUDA stream) and the
sharded decode over a mesh of devices and processes
(:func:`decompress_sharded`, ``lz4tpu_torch.dist``).  The encoder
finds matches on the device (``compress(backend="device"|"device-emit")``,
``dist.compress_sharded``; ``lz4tpu_torch.device.encode``), and the
console tools run as ``python -m lz4tpu_torch.cli <tool>``.
Every kernel is CUDA C++ for ``sm_90a`` (``csrc/``) beside a plain
PyTorch version that runs on the CPU.
"""

from .constants import (
    FOR_ALL,
    FOR_LEGACY,
    FOR_MODERN,
    HISTORY_SIZE,
    EndOfFrame,
    Reservation,
)
from .errors import (
    ChecksumError,
    DataCorruption,
    Lz4Error,
    NotSupported,
    TooFewHeaderBytes,
    TooLittleMemory,
    hex8,
    hex32,
)
from .stream import Decompressor, Format
from .xxh32 import XXHash32, xxh32
from .api import (
    Compressor,
    compress,
    decompress,
    decompress_host,
    decompress_into,
    min_buffer_size,
)
from .pipeline import decompress_device, decompress_to_device
from .dist import decompress_sharded


def __getattr__(name):
    """PEP 562 lazy re-export: ``lz4tpu_torch.DecodeSession`` is the
    class in :mod:`lz4tpu_torch.serve` (so isinstance and identity
    work), imported on first touch."""
    if name == "DecodeSession":
        from .serve import DecodeSession as _cls

        globals()["DecodeSession"] = _cls
        return _cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    "Decompressor",
    "Format",
    "XXHash32",
    "xxh32",
    "Compressor",
    "compress",
    "decompress",
    "decompress_host",
    "decompress_into",
    "min_buffer_size",
    "decompress_to_device",
    "decompress_device",
    "DecodeSession",
    "decompress_sharded",
    "Reservation",
    "EndOfFrame",
    "FOR_ALL",
    "FOR_LEGACY",
    "FOR_MODERN",
    "HISTORY_SIZE",
    "Lz4Error",
    "ChecksumError",
    "DataCorruption",
    "NotSupported",
    "TooFewHeaderBytes",
    "TooLittleMemory",
    "hex8",
    "hex32",
    "__version__",
]
