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
segment-copy kernel, the byte-parallel resolver) and checksum
verification on the device (``verify="device"``).  Every kernel is CUDA
C++ for ``sm_90a`` (``csrc/``) beside a plain PyTorch version that runs
on the CPU.
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


class DecodeSession:
    """Not ported yet: the request pipeline of ``lz4tpu.serve``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "lz4tpu_torch.DecodeSession: the request pipeline "
            "(lz4tpu.serve) is not ported yet")


def decompress_sharded(*args, **kwargs):
    """Not ported yet: multi-device decode of ``lz4tpu.dist`` and
    ``lz4tpu.spans``."""
    raise NotImplementedError(
        "lz4tpu_torch.decompress_sharded: multi-device decode "
        "(lz4tpu.dist, lz4tpu.spans) is not ported yet")


def compress_device(*args, **kwargs):
    """Not ported yet: the device encoder of ``lz4tpu.device.encode``."""
    raise NotImplementedError(
        "lz4tpu_torch.compress_device: the device encoder "
        "(lz4tpu.device.encode) is not ported yet")


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
    "compress_device",
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
]
