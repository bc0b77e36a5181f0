"""xxhash32 on the device (port of ``lz4tpu.device.xxh32_pallas``).

xxh32 is a sequentially chained hash: four 32-bit lane accumulators fed
16-byte stripes, then a serial avalanche.  The chain cannot be
parallelised (the update is not associative), so each kernel keeps one
chain on four threads and everything else off it:

* H4 :func:`xxh32_stream` (``csrc/xxh32.cu``): the lane state over ``n``
  stripes of a device array from any byte offset, from a caller's state
  to the state after, so a caller can carry a chain from range to
  range.  :func:`xxh32_device` and :func:`xxh32_of_device_array` call
  it with the seed-0 state.
* H5 :func:`xxh32_blocks`: the lane states of every block of the
  compressed buffer in one launch, one thread block per LZ4 block.

Each has a plain PyTorch version (``*_plain``: a Python loop over
stripes, for small sizes), taken only for CPU tensors.  The kernels
compute lane states; the final avalanche over the <=15 tail bytes runs
on the host (it touches a constant number of bytes).  Only lane states
and tails cross to the host, one fetch per range or per batch of
blocks.

Use is ``decompress_to_device(verify="device")``, for data that should
never leave device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..xxh32 import XXHash32
from . import to_device

P1 = 2654435761
P2 = 2246822519
_M32 = 0xFFFFFFFF

_SEEDS: dict = {}       # (device, seed) -> the constant start state


def seed_state(device, seed: int = 0) -> torch.Tensor:
    """The ``(4,) int32`` lane state before any stripe (one read-only
    tensor per device and seed, staged once)."""
    key = (str(torch.device(device)), seed)
    if key not in _SEEDS:
        _SEEDS[key] = lane_state_from_numpy(np.array(
            [(seed + P1 + P2) & _M32, (seed + P2) & _M32, seed & _M32,
             (seed - P1) & _M32], np.uint32).astype(np.int32), device)
    return _SEEDS[key]


def lane_state_from_numpy(state: np.ndarray, device) -> torch.Tensor:
    """A ``(4,) int32`` lane state (the JAX package's K7 state, fetched
    as numpy) as the port's tensor on ``device``: a hash begun in one
    package continues in the other."""
    arr = np.asarray(state)
    if arr.shape != (4,) or arr.dtype not in (np.int32, np.uint32):
        raise ValueError("lane state must be (4,) int32")
    return to_device(arr.astype(np.int32), device)


def lane_state_to_numpy(state: torch.Tensor) -> np.ndarray:
    """The port's lane state as ``(4,) int32`` numpy."""
    if tuple(state.shape) != (4,) or state.dtype != torch.int32:
        raise ValueError("lane state must be a (4,) int32 tensor")
    return state.cpu().numpy()


# ---------------------------------------------------------------------------
# H4: one chain over a device-resident range
# ---------------------------------------------------------------------------

def xxh32_stream(arr: torch.Tensor, lo: int, n_stripes: int,
                 state_in: torch.Tensor) -> torch.Tensor:
    """Lane state after the ``n_stripes`` 16-byte stripes of
    ``arr[lo : lo + 16 * n_stripes]``, continuing ``state_in``:
    ``(4,) int32`` on ``arr``'s device.  ``lo`` is any byte offset."""
    if lo < 0 or n_stripes < 0 or lo + 16 * n_stripes > arr.shape[0]:
        raise ValueError(
            f"stripes [{lo}, {lo + 16 * n_stripes}) leave the array "
            f"({arr.shape[0]} bytes)")
    if arr.device.type == "cpu":
        return xxh32_stream_plain(arr, lo, n_stripes, state_in)
    _kernels.check(arr, "arr", torch.uint8, (arr.shape[0],), align=1)
    _kernels.check(state_in, "state_in", torch.int32, (4,), align=4)
    if state_in.device != arr.device:
        raise ValueError(f"state_in is on {state_in.device}, arr on "
                         f"{arr.device}")
    if n_stripes == 0:
        return state_in.clone()
    state_out = torch.empty(4, dtype=torch.int32, device=arr.device)
    _kernels.launch(
        "xxh32_stream", "lz4t_xxh32_stream", arr.device,
        arr.data_ptr() + lo, n_stripes, state_in.data_ptr(),
        state_out.data_ptr())
    return state_out


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for int64 ``a`` in ``[0, 2**32)`` without
    leaving int64's range."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _words(data: torch.Tensor) -> torch.Tensor:
    """Little-endian 32-bit words of a uint8 ``(..., 4 * k)`` tensor as
    int64 ``(..., k)``."""
    b = data.to(torch.int64).reshape(*data.shape[:-1],
                                     data.shape[-1] // 4, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _round(s: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """One stripe: ``rotl(s + w * P2, 13) * P1`` with ``wp = w * P2``."""
    s = (s + wp) & _M32
    s = ((s << 13) | (s >> 19)) & _M32
    return _mul32(s, P1)


def _to_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` as the int32 of the same bits."""
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def xxh32_stream_plain(arr: torch.Tensor, lo: int, n_stripes: int,
                       state_in: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`xxh32_stream`: int64 lanes masked
    to 32 bits, a Python loop over the stripes (small sizes only)."""
    s = state_in.to(torch.int64) & _M32
    wp = _mul32(_words(arr[lo:lo + 16 * n_stripes].reshape(-1, 16)), P2)
    for i in range(n_stripes):
        s = _round(s, wp[i])
    return _to_i32(s)


# ---------------------------------------------------------------------------
# H5: every block's chain in one launch
# ---------------------------------------------------------------------------

def xxh32_blocks(comp: torch.Tensor, offsets: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Seed-0 lane states of the blocks ``comp[offsets[b] : offsets[b] +
    lengths[b]]`` (whole stripes only): int32 ``(n_blocks, 4)``.
    ``offsets`` and ``lengths`` are int64 ``(n_blocks,)``, in range."""
    if comp.device.type == "cpu":
        return xxh32_blocks_plain(comp, offsets, lengths)
    n_b = offsets.shape[0]
    _kernels.check(comp, "comp", torch.uint8, (comp.shape[0],), align=1)
    _kernels.check(offsets, "offsets", torch.int64, (n_b,), align=8)
    _kernels.check(lengths, "lengths", torch.int64, (n_b,), align=8)
    states = torch.empty((n_b, 4), dtype=torch.int32, device=comp.device)
    if n_b:
        _kernels.launch(
            "xxh32_blocks", "lz4t_xxh32_blocks", comp.device,
            comp.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), n_b,
            states.data_ptr())
    return states


def xxh32_blocks_plain(comp: torch.Tensor, offsets: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`xxh32_blocks`: the stripe loop
    runs to the longest block, all blocks at once, a block keeping its
    state once its stripes are done."""
    n_b = offsets.shape[0]
    dev = comp.device
    s = (seed_state(dev).to(torch.int64) & _M32).repeat(n_b, 1)
    n_str = lengths // 16
    k16 = torch.arange(16, device=dev)
    for i in range(int(n_str.max()) if n_b else 0):
        live = n_str > i
        idx = (offsets + 16 * i).unsqueeze(1) + k16
        stripe = comp[idx.clamp(max=comp.shape[0] - 1)]
        nxt = _round(s, _mul32(_words(stripe), P2))
        s = torch.where(live.unsqueeze(1), nxt, s)
    return _to_i32(s)


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

def _finalize(state: np.ndarray, n: int, tail: bytes) -> int:
    """Fold the 4-lane state + <16-byte tail into the digest (host;
    constant work; reference: lz4ada.adb:993-1017)."""
    s0, s1, s2, s3 = (int(x) & _M32 for x in state)

    def rotl(v, r):
        return ((v << r) | (v >> (32 - r))) & _M32

    h = (rotl(s0, 1) + rotl(s1, 7) + rotl(s2, 12) + rotl(s3, 18)) & _M32
    h = (h + n) & _M32
    i = 0
    P3, P4, P5 = 3266489917, 668265263, 374761393
    while i + 4 <= len(tail):
        w = int.from_bytes(tail[i:i + 4], "little")
        h = (rotl((h + w * P3) & _M32, 17) * P4) & _M32
        i += 4
    while i < len(tail):
        h = (rotl((h + tail[i] * P5) & _M32, 11) * P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * P2) & _M32
    h ^= h >> 13
    h = (h * P3) & _M32
    h ^= h >> 16
    return h


def _as_device_bytes(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8 or data.ndim != 1:
            raise ValueError("data must be a 1-D uint8 tensor")
        return data.to(device) if device is not None else data
    arr = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return to_device(arr, "cuda" if device is None else device)


def xxh32_device(data, device="cuda") -> int:
    """xxh32(seed=0) of a byte buffer (numpy array or uint8 tensor,
    staged on ``device``) with the stripe loop on the device.

    Bit-exact with the reference; the tail (< 16 bytes) and avalanche
    fold run on the host.
    """
    arr = _as_device_bytes(data, device)
    n = arr.shape[0]
    n_stripes = n // 16
    if n_stripes == 0:
        return XXHash32().update(arr.cpu().numpy().tobytes()).final()
    state = xxh32_stream(arr, 0, n_stripes, seed_state(arr.device))
    return _fold(state, arr, n_stripes * 16, n)


def _fold(state: torch.Tensor, arr: torch.Tensor, tail_lo: int,
          n: int) -> int:
    """One fetch of the lane state and the tail ``arr[tail_lo :
    tail_lo + n % 16]``, then the host avalanche."""
    n_tail = n % 16
    both = torch.cat([state.view(torch.uint8),
                      arr[tail_lo:tail_lo + n_tail]]).cpu().numpy()
    return _finalize(both[:16].view(np.int32), n, both[16:].tobytes())


def xxh32_of_device_array(arr: torch.Tensor, lo: int, hi: int) -> int:
    """xxh32(seed=0) of ``arr[lo:hi]`` where ``arr`` is a uint8 tensor
    that stays on its device: the content-checksum path of
    ``decompress_to_device(verify="device")``.

    One launch covers the whole range from any ``lo``; only the 16-byte
    lane state and the <16-byte stripe tail cross to the host (a range
    with no whole stripe is its own tail).  The JAX package fetches
    ranges under 8 MiB and hashes them on the host, a threshold set by
    the TPU's dispatch cost; on an NVIDIA H100 the launch costs less
    than the copy from 1 MiB up and at most 0.04 ms more below
    (``chip_smoke.py``, its ``[small_fetch]`` lines), so the port has
    no such branch and the decoded bytes stay on the device.
    """
    n = hi - lo
    if n <= 0:
        return XXHash32().final()
    if n < 16:
        return XXHash32().update(arr[lo:hi].cpu().numpy().tobytes()).final()
    n_stripes = n // 16
    state = xxh32_stream(arr, lo, n_stripes, seed_state(arr.device))
    return _fold(state, arr, lo + n_stripes * 16, n)


def xxh32_blocks_device(comp, offsets, lengths, device=None) -> list[int]:
    """Per-block xxh32(seed=0) digests with the stripe loops on the
    device in ONE kernel launch.

    ``comp`` is the compressed buffer, a uint8 tensor already on its
    device (or a numpy array, staged on ``device``); ``offsets`` /
    ``lengths`` delimit the blocks.  The kernel reads every block in
    place, and only the ``(n_blocks, 4)`` lane states plus the <16-byte
    tails cross back to the host, in one fetch, for the avalanche fold.
    """
    offsets = [int(o) for o in offsets]
    lengths = [int(n) for n in lengths]
    n_blocks = len(offsets)
    if n_blocks == 0:
        return []
    comp_dev = _as_device_bytes(comp, device)
    dev = comp_dev.device
    size = comp_dev.shape[0]
    if any(o < 0 or n < 0 or o + n > size
           for o, n in zip(offsets, lengths)):
        raise ValueError("a block leaves the compressed buffer")
    off_t = torch.tensor(offsets, dtype=torch.int64, device=dev)
    len_t = torch.tensor(lengths, dtype=torch.int64, device=dev)
    states = xxh32_blocks(comp_dev, off_t, len_t)
    # one batched fetch: states + 16-byte tail windows
    tail_idx = ((off_t + (len_t // 16) * 16).unsqueeze(1)
                + torch.arange(16, device=dev))
    tails = comp_dev[tail_idx.clamp(max=size - 1)] if size else \
        torch.zeros((n_blocks, 16), dtype=torch.uint8, device=dev)
    both = torch.cat([states.view(torch.uint8).reshape(n_blocks, 16),
                      tails], 1).cpu().numpy()
    digests = []
    for b, n in enumerate(lengths):
        tail = both[b, 16:16 + n % 16].tobytes()
        if n // 16 == 0:
            digests.append(XXHash32().update(tail).final())
        else:
            digests.append(_finalize(both[b, :16].view(np.int32), n, tail))
    return digests
