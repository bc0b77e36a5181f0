"""What the benchmark takes from the program (``lz4tpu_torch``) besides
its entry points: the refusal of its host fallback, and its counters.

The program's device entry points hand any error to the host engine
(``pipeline._host_fallback``, which looks ``api.decompress_host`` up at
each call).  Within :func:`fallback_refused` that call raises
:class:`FallbackRefused` instead, so every byte of an answer comes from
the card, and a request the host would have served counts as failed.
The counters (kernel launches, host fallbacks) are recorded, never
asserted: a later change may route a request through other kernels.
"""

from __future__ import annotations

import contextlib


class FallbackRefused(Exception):
    """A device entry point handed a frame to the host engine."""


@contextlib.contextmanager
def fallback_refused():
    from lz4tpu_torch import api

    real = api.decompress_host

    def refuse(data, reservation=None):
        raise FallbackRefused("the device entry point fell back to the "
                              "host engine (decompress_host)")

    api.decompress_host = refuse
    try:
        yield
    finally:
        api.decompress_host = real


def _fallbacks() -> int | None:
    try:
        from lz4tpu_torch import pipeline
        return int(pipeline.HOST_FALLBACKS)
    except (ImportError, AttributeError):
        return None


class Counters:
    """The program's own counters since :meth:`reset`: kernel launches by
    name and host fallbacks; a counter the program no longer has is
    left out."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        try:
            from lz4tpu_torch import _kernels
            _kernels.reset_launches()
        except (ImportError, AttributeError):
            pass
        self._fallbacks = _fallbacks()

    def read(self) -> dict:
        out = {}
        try:
            from lz4tpu_torch import _kernels
            out["launches"] = {k: v for k, v in _kernels.LAUNCHES.items()
                               if v}
        except (ImportError, AttributeError):
            pass
        now = _fallbacks()
        if now is not None and self._fallbacks is not None:
            out["host_fallbacks"] = now - self._fallbacks
        return out
