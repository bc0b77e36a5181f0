"""Device engines of the port: sparse programs with the block-fill
kernel, the fused kernel, the mxu2 kernel, the segment-copy kernel, the
byte-parallel resolver and the xxh32 kernels."""

from __future__ import annotations

import warnings

import numpy as np
import torch


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  A read-only array (a
    view of a ``bytes`` input) is wrapped without a copy on the CPU;
    the port only reads such tensors."""
    a = np.ascontiguousarray(a)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        return torch.from_numpy(a).to(device)


def native_engine():
    """``lz4tpu_torch.native``, which the fused prep and the mxu2
    packer require (the port carries no numpy fallback)."""
    from .. import native

    if not native.available():
        raise RuntimeError(
            "lz4tpu_torch: the native engine (lz4tpu_torch.native, built "
            "with g++) is required for the fused and mxu2 host prep")
    return native
