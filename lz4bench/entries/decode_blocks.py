"""Decode entry for requests of raw LZ4 blocks with no frame: the pages of
a Parquet row group under the codec LZ4_RAW (or any input laid out as
they are), each page compressed as one independent raw block, the blocks
of a request end to end and decoded by one
``lz4tpu_torch.decompress_blocks_to_device(blocks, comp_sizes,
out_sizes, device=...)``, the two size tables being what a reader takes
from the page headers.

A request's input (``Request.raw``) is a sequence of page bodies, each
prefixed by its length as a little-endian int64 and padded with zeros to
a multiple of 8 bytes (``corpora/tpch_lineitem_parquet.py``; the layout
of ``decode_frames``).  Each page becomes one raw block of the
benchmark's frozen encoder at the configuration's level, with no
history: a page that does not shrink is still written as a block, all
literals, as LZ4_RAW has no stored form.

The answer is a uint8 tensor on the card that has to equal the pages
end to end, with no prefix and no padding; it is compared on the card as
each answer comes back.  Numbers compared, each with its limit:

* ``wrong_bytes``: bytes of all answers that differ from the pages, a
  missing or extra byte counting as one (limit 0);
* ``failed``: requests that raised, a host fallback among them (limit 0).

That the frozen encoder's blocks decode to their pages by the plain
reference (``lz4bench/reference_parquet.py``) is held by a CPU test
(``tests/test_lz4bench_parquet.py``), not by every run.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from lz4bench import encoder, harness, program

_Decode = harness.entry_class("decode")
split = harness._load_file(harness.HERE / "entries" / "decode_frames.py",
                           "entry").split

#: The blocks are written on up to this many threads.
WORKERS = 8


def compress_block(page: np.ndarray, level: int) -> np.ndarray:
    """One independent raw LZ4 block of ``page`` by the frozen encoder at
    ``level`` (its chain depth and lazy matching as ``compress_frame``
    maps a level), whether or not it shrinks."""
    if level >= 10:
        raise ValueError("the frozen encoder has no optimal parser (level "
                         ">= 10)")
    max_chain = (min(encoder.MAX_CHAIN, 8) if level <= 3
                 else encoder.MAX_CHAIN)
    return encoder._block(np.ascontiguousarray(page, np.uint8), 0, page.size,
                          False, max_chain, level >= 4)


class Entry(_Decode):
    def __init__(self, requests, config, traffic, dev):
        import lz4tpu_torch

        # a program without the entry point cannot run the cell: say so
        # before the blocks are written
        if not hasattr(lz4tpu_torch, "decompress_blocks_to_device"):
            raise harness.BenchError("the program has no "
                                     "decompress_blocks_to_device")
        self.requests = requests
        self.dev = dev
        self.pages = [split(r.raw) for r in requests]
        with concurrent.futures.ThreadPoolExecutor(
                min(WORKERS, os.cpu_count() or 1)) as pool:
            self.blocks = [list(pool.map(
                lambda p: compress_block(p, config["level"]), pages))
                for pages in self.pages]
        self.joined = [np.concatenate(b).tobytes() for b in self.blocks]
        self.comp_sizes = [np.array([b.size for b in blocks], np.int64)
                           for blocks in self.blocks]
        self.out_sizes = [np.array([p.size for p in pages], np.int64)
                          for pages in self.pages]
        self.refs = [torch.from_numpy(np.concatenate(pages)).to(dev)
                     for pages in self.pages]
        self.counter = program.Counters()
        self._bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.wrong_bytes = 0
        self.failed = 0

    def call(self, k: int) -> torch.Tensor:
        import lz4tpu_torch

        return lz4tpu_torch.decompress_blocks_to_device(
            self.joined[k], self.comp_sizes[k], self.out_sizes[k],
            device=self.dev)

    def raw_bytes(self, k: int) -> int:
        return self.refs[k].numel()

    def comp_bytes(self, k: int, answer) -> int:
        return len(self.joined[k])

    def after_window(self) -> None:
        self.wrong_bytes += int(self._bad.item())

    def judge(self) -> dict:
        checks = {"wrong_bytes": self.wrong_bytes, "failed": self.failed}
        return {k: {"value": v, "limit": 0} for k, v in checks.items()}
