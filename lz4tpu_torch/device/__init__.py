"""Device engines of the port: sparse programs with the block-fill
kernel, the fused kernel, the mxu2 kernel, the segment-copy kernel, the
byte-parallel resolver and the xxh32 kernels."""

from __future__ import annotations

import warnings

import numpy as np
import torch


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``.

    CPU: a read-only array (a view of a ``bytes`` input) is wrapped
    without a copy; the port only reads such tensors.

    CUDA: the array is copied into a pinned staging tensor and from
    there to the card with ``non_blocking=True`` on the calling thread's
    current stream, so the host does not wait for the stream's earlier
    work (a copy from pageable memory does).  ``a`` may be overwritten
    as soon as this returns: the host-side copy into the staging tensor
    is synchronous, and PyTorch's pinned-memory allocator hands a
    staging block out again only after the event of its last copy has
    passed."""
    a = np.ascontiguousarray(a)
    dev = torch.device(device)
    if a.flags.writeable:
        host = torch.from_numpy(a)
    else:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable", UserWarning)
            host = torch.from_numpy(a)
    if dev.type != "cuda":
        return host.to(dev)
    staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    staged.copy_(host)
    return staged.to(dev, non_blocking=True)


_PACK_ALIGN = 256


def to_device_packed(arrays, device) -> list:
    """Several host arrays as tensors on ``device`` at the price of one
    staging tensor and one copy: the arrays are laid end to end (each at
    a 256-byte boundary) in one pinned buffer, copied as :func:`to_device`
    copies, and handed back as views of the one device buffer.  For the
    small tables of a launch (window indices, scalars, segment tables),
    where a pinned tensor and a copy each cost more than the bytes.  The
    views share one allocation and are freed together."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    dev = torch.device(device)
    if dev.type != "cuda":
        return [to_device(a, dev) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // _PACK_ALIGN) * _PACK_ALIGN
    staged = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    flat = staged.numpy()
    for a, off in zip(arrays, offs):
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    on_dev = staged.to(dev, non_blocking=True)
    return [on_dev[off:off + a.nbytes]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            .reshape(a.shape) for a, off in zip(arrays, offs)]


def native_engine():
    """``lz4tpu_torch.native``, which the fused prep and the mxu2
    packer require (the port carries no numpy fallback)."""
    from .. import native

    if not native.available():
        raise RuntimeError(
            "lz4tpu_torch: the native engine (lz4tpu_torch.native, built "
            "with g++) is required for the fused and mxu2 host prep")
    return native
