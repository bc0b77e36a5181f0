"""Device engines of the port: sparse programs with the block-fill
kernel, the fused kernel, the mxu2 kernel, the segment-copy kernel, the
byte-parallel resolver and the xxh32 kernels."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..trace import count, span


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
    passed.

    Spans ``stage`` and, inside it, ``stage.pin`` (the host's pinned
    allocation and copy); counter ``h2d_bytes``: the bytes handed in."""
    a = np.ascontiguousarray(a)
    dev = torch.device(device)
    count("h2d_bytes", a.nbytes)
    with span("stage"):
        if a.flags.writeable:
            host = torch.from_numpy(a)
        else:
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The given NumPy array is "
                                        "not writable", UserWarning)
                host = torch.from_numpy(a)
        if dev.type != "cuda":
            return host.to(dev)
        with span("stage.pin"):
            staged = torch.empty(host.shape, dtype=host.dtype,
                                 pin_memory=True)
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
    views share one allocation and are freed together.  Spans and counter
    as :func:`to_device`'s."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    dev = torch.device(device)
    if dev.type != "cuda":
        return [to_device(a, dev) for a in arrays]
    offs, total, handed = [], 0, 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // _PACK_ALIGN) * _PACK_ALIGN
        handed += a.nbytes
    count("h2d_bytes", handed)
    with span("stage"):
        with span("stage.pin"):
            staged = torch.empty(max(total, 1), dtype=torch.uint8,
                                 pin_memory=True)
            flat = staged.numpy()
            for a, off in zip(arrays, offs):
                flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        on_dev = staged.to(dev, non_blocking=True)
    return [on_dev[off:off + a.nbytes]
            .view(torch.from_numpy(np.empty(0, a.dtype)).dtype)
            .reshape(a.shape) for a, off in zip(arrays, offs)]



def to_device_rows(columns, ranges, device) -> torch.Tensor:
    """Equal-typed host columns, cut to ``ranges`` (``[(lo, hi)]``, the
    same for each column) and laid end to end, as the rows of one
    ``(len(columns), n)`` tensor on ``device``: each column's pieces go
    straight into one pinned staging tensor, with no host copy between,
    and that is copied as :func:`to_device` copies.  Spans and counter
    as :func:`to_device`'s."""
    dtype = np.dtype(columns[0].dtype)
    n = sum(hi - lo for lo, hi in ranges)
    dev = torch.device(device)
    count("h2d_bytes", len(columns) * n * dtype.itemsize)
    with span("stage"):
        with span("stage.pin"):
            staged = torch.empty((len(columns), n),
                                 dtype=torch.from_numpy(
                                     np.empty(0, dtype)).dtype,
                                 pin_memory=dev.type == "cuda")
            host = staged.numpy()
            for row, col in zip(host, columns):
                if ranges:
                    np.concatenate([col[lo:hi] for lo, hi in ranges],
                                   out=row)
        if dev.type != "cuda":
            return staged
        return staged.to(dev, non_blocking=True)
