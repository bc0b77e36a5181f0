"""Encode entry: ``lz4tpu_torch.compress(data, backend=<the traffic's
backend>, device=..., **<the configuration's frame flags>, level=...)``.

The answer is a frame (bytes).  Every answer is kept, and once the
window has closed each distinct answer of each input is judged by the
plain reference (:func:`lz4bench.reference.check_frame`): its
descriptor against the configuration, every block decoded (a block of
an independent frame may not reach before its start), the bytes against
the input, and the content checksum against the input's.  Numbers
compared, each with its limit, counted over all answers:

* ``frames_wrong``: answers that do not decode to their input (limit 0);
* ``header_wrong``: answers whose descriptor is not the configuration's
  (limit 0);
* ``checksum_wrong``: answers whose content checksum is wrong or missing
  (limit 0);
* ``failed``: requests that raised (limit 0).
"""

from __future__ import annotations

import collections
import sys

import torch

from lz4bench import program, reference


class Entry:
    def __init__(self, requests, config, traffic, dev):
        self.requests = requests
        self.dev = dev
        self.flags = dict(config["frame"])
        self.level = config["level"]
        self.backend = traffic["backend"]
        self.data = [r.raw.tobytes() for r in requests]
        self.counter = program.Counters()
        self.answers = []               # (input, frame), in order
        self.failed = 0

    def call(self, k: int) -> bytes:
        import lz4tpu_torch

        return lz4tpu_torch.compress(
            self.data[k], backend=self.backend, device=self.dev,
            level=self.level, **self.flags)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def fallback_refused(self):
        return program.fallback_refused()

    def raw_bytes(self, k: int) -> int:
        return len(self.data[k])

    def comp_bytes(self, k: int, answer) -> int:
        return 0 if answer is None else len(answer)

    def keep(self, k: int, frame: bytes) -> None:
        self.answers.append((k, frame))

    def note_failure(self, k: int, e: Exception) -> None:
        self.failed += 1
        if self.failed == 1:
            print(f"[lz4bench] request of input {k} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def after_window(self) -> None:
        pass

    def judge(self) -> dict:
        # equal answers to one input are judged once
        times = collections.Counter(self.answers)
        wrong = collections.Counter()
        for (k, frame), n in times.items():
            r = self.requests[k]
            for name, bad in reference.check_frame(
                    frame, r.raw, self.flags, r.raw_xxh32).items():
                wrong[name] += bad * n
        print(f"[lz4bench] judged {len(self.answers)} answer(s), "
              f"{len(times)} distinct", file=sys.stderr, flush=True)
        checks = {"frames_wrong": wrong["content"],
                  "header_wrong": wrong["header"],
                  "checksum_wrong": wrong["checksum"],
                  "failed": self.failed}
        return {k: {"value": v, "limit": 0} for k, v in checks.items()}

    def reset_counters(self) -> None:
        self.counter.reset()

    def counters(self) -> dict:
        return self.counter.read()
