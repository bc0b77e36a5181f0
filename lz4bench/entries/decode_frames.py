"""Decode entry for requests of many frames: the buffers of Arrow IPC
record batches (or any input laid out as they are), each compressed as
one LZ4 frame, the frames of a request concatenated in buffer order and
decoded by one ``lz4tpu_torch.decompress_to_device(frames, device=...,
verify=<the configuration's verify>)``.

A request's input (``Request.raw``) is a sequence of buffers, each
prefixed by its length as a little-endian int64 and padded with zeros to
a multiple of 8 bytes: the body of an Arrow record batch with
``BodyCompression`` method ``BUFFER``, before compression
(``corpora/tpch_lineitem.py``).  Each non-empty buffer becomes one frame
of the benchmark's frozen encoder at the configuration's flags and
level; the harness's whole-input frame (``Request.frame``) is not used.

The answer is a uint8 tensor on the card that has to equal the buffers
end to end, with no prefix and no padding: it is compared on the card as
each answer comes back, as the decode entry does.  Numbers compared,
each with its limit:

* ``wrong_bytes``: bytes of all answers that differ from the buffers, a
  missing or extra byte counting as one (limit 0);
* ``failed``: requests that raised, a host fallback among them (limit 0).

That the frozen encoder's frames decode to their buffers by the plain
reference (``lz4bench/reference.py``) is held by a CPU test
(``tests/test_lz4bench_tpch.py``), not by every run.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from lz4bench import encoder, harness, program

_Decode = harness.entry_class("decode")

#: The frames are written on up to this many threads.
WORKERS = 8


def split(raw: np.ndarray) -> list:
    """The non-empty buffers of a body laid out as the module says."""
    out, pos = [], 0
    while pos < raw.size:
        n = int(raw[pos:pos + 8].view("<i8")[0])
        if n < 0 or pos + 8 + n > raw.size:
            raise ValueError(f"buffer of {n} B at {pos} runs past the body")
        if n:
            out.append(raw[pos + 8:pos + 8 + n])
        pos += 8 + n + (-n) % 8
    return out


class Entry(_Decode):
    def __init__(self, requests, config, traffic, dev):
        self.requests = requests
        self.dev = dev
        self.verify = config["verify"]
        self.buffers = [split(r.raw) for r in requests]
        # one frame a buffer, the buffers on threads (the frozen encoder
        # releases the interpreter lock)
        with concurrent.futures.ThreadPoolExecutor(
                min(WORKERS, os.cpu_count() or 1)) as pool:
            self.frames = [list(pool.map(
                lambda b: encoder.compress_frame(b, config["frame"],
                                                 config["level"], workers=1),
                bufs)) for bufs in self.buffers]
        self.joined = [b"".join(f) for f in self.frames]
        self.refs = [torch.from_numpy(np.concatenate(bufs)).to(dev)
                     for bufs in self.buffers]
        self.counter = program.Counters()
        self._bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.wrong_bytes = 0
        self.failed = 0

    def call(self, k: int) -> torch.Tensor:
        return self.decode(self.joined[k])

    def raw_bytes(self, k: int) -> int:
        return self.refs[k].numel()

    def comp_bytes(self, k: int, answer) -> int:
        return len(self.joined[k])

    def after_window(self) -> None:
        self.wrong_bytes += int(self._bad.item())

    def judge(self) -> dict:
        checks = {"wrong_bytes": self.wrong_bytes, "failed": self.failed}
        return {k: {"value": v, "limit": 0} for k, v in checks.items()}
