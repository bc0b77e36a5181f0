"""lz4tpu_torch — the lz4tpu LZ4 codec on PyTorch and CUDA (Hopper).

A port of ``lz4tpu`` beside it.  This slice covers the batched device
decode, :func:`decompress_to_device`, with its three engines: sparse
programs (block-fill kernel), the fused kernel and the mxu2 kernel,
each a CUDA C++ kernel for ``sm_90a`` (``csrc/``) beside a plain
PyTorch version that runs on the CPU.  The host layer (frame parse,
native token scan, checksums, the streaming host engine) is
``lz4tpu``'s own, imported; nothing here imports JAX.

The exception classes are ``lz4tpu``'s, so ``except`` clauses written
for one package match errors from the other.
"""

from lz4tpu.constants import (
    FOR_ALL,
    FOR_LEGACY,
    FOR_MODERN,
    Reservation,
)
from lz4tpu.errors import (
    ChecksumError,
    DataCorruption,
    Lz4Error,
    NotSupported,
    TooFewHeaderBytes,
    TooLittleMemory,
)

from .pipeline import decompress_to_device


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
    "decompress_to_device",
    "DecodeSession",
    "decompress_sharded",
    "compress_device",
    "Reservation",
    "FOR_ALL",
    "FOR_LEGACY",
    "FOR_MODERN",
    "Lz4Error",
    "ChecksumError",
    "DataCorruption",
    "NotSupported",
    "TooFewHeaderBytes",
    "TooLittleMemory",
]
