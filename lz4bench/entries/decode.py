"""Decode entry: ``lz4tpu_torch.decompress_to_device(frame, device=...,
verify=<the configuration's verify>)``, the frame written by the
benchmark's frozen encoder.

The answer is a uint8 tensor on the card.  Each one is compared on the
card with the original bytes as it comes back (the count of differing
bytes accumulates there, with no wait), and the count is read once the
window has closed.  After the window, each distinct frame is sent once
more with its content checksum altered: the program has to refuse it.
Numbers compared, each with its limit:

* ``wrong_bytes``: bytes of all answers that differ from the original,
  a missing or extra byte counting as one (limit 0);
* ``failed``: requests that raised, a host fallback among them (limit 0);
* ``verify_missed``: altered checksums the program accepted (limit 0).
"""

from __future__ import annotations

import sys

import torch

from lz4bench import program


class Entry:
    def __init__(self, requests, config, traffic, dev):
        self.requests = requests
        self.dev = dev
        self.verify = config["verify"]
        self.checksummed = config["frame"]["content_checksum"]
        self.refs = [torch.from_numpy(r.raw).to(dev) for r in requests]
        self.counter = program.Counters()
        self._bad = torch.zeros((), dtype=torch.int64, device=dev)
        self.wrong_bytes = 0
        self.failed = 0
        self.verify_missed = 0

    # -- the timed call -----------------------------------------------------

    def call(self, k: int) -> torch.Tensor:
        return self.decode(self.requests[k].frame)

    def decode(self, frame: bytes) -> torch.Tensor:
        import lz4tpu_torch

        return lz4tpu_torch.decompress_to_device(
            frame, device=self.dev, verify=self.verify)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def fallback_refused(self):
        return program.fallback_refused()

    def raw_bytes(self, k: int) -> int:
        return self.requests[k].raw.size

    def comp_bytes(self, k: int, answer) -> int:
        return len(self.requests[k].frame)

    # -- the check ----------------------------------------------------------

    def keep(self, k: int, out: torch.Tensor) -> None:
        ref = self.refs[k]
        n = min(out.numel(), ref.numel())
        self.wrong_bytes += abs(out.numel() - ref.numel())
        self._bad += (out.reshape(-1)[:n] != ref[:n]).sum()

    def note_failure(self, k: int, e: Exception) -> None:
        self.failed += 1
        if self.failed == 1:
            print(f"[lz4bench] request of input {k} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def after_window(self) -> None:
        self.wrong_bytes += int(self._bad.item())
        if not self.checksummed:
            return
        for k, r in enumerate(self.requests):
            bad = bytearray(r.frame)
            bad[-1] ^= 0x01         # the stored content checksum
            try:
                out = self.decode(bytes(bad))
                self.sync()
            except Exception:       # refused: the guarantee holds
                continue
            del out
            self.verify_missed += 1

    def judge(self) -> dict:
        checks = {"wrong_bytes": self.wrong_bytes, "failed": self.failed}
        if self.checksummed:
            checks["verify_missed"] = self.verify_missed
        return {k: {"value": v, "limit": 0} for k, v in checks.items()}

    # -- what the traced run reads ------------------------------------------

    def reset_counters(self) -> None:
        self.counter.reset()

    def counters(self) -> dict:
        return self.counter.read()

    @staticmethod
    def describe_plan(plan) -> dict | None:
        """The engine mix of a ``pipeline.plan_decode`` result: chains a
        decode engine plans."""
        mix = {}
        for engine, attr in (("sparse", "sparse"), ("dense", "dense_chains"),
                             ("fused", "fused_chains"), ("other", "other")):
            chains = getattr(plan, attr, None)
            if chains:
                mix[engine] = len(chains)
        return mix or None
