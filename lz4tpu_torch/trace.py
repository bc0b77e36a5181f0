"""The port's own spans and counters, at its layer boundaries.

Inside :func:`recording`, ``with span(name):`` records the host's time in
a layer of the program (name, parent, request, thread, start and end on
``time.perf_counter_ns``) and enters
``torch.profiler.record_function("lz4tpu_torch." + name)``, so that under
a profiler the same range lies on the profiler's timeline beside the
card's operations: every idle gap of the card falls under the name of
what the host was doing.  :func:`count` adds to a named counter.

Outside every recording, :func:`span` hands back one shared null context
and :func:`count` returns at once: no clock read, no allocation, no
``record_function``.  Nothing here waits for the card.

A span opened while no span of the program is open on its thread starts
a request: the spans opened inside it on that thread carry its id as
their request id.  Recordings may nest and overlap, on any thread: each
open recording receives every span opened and every count made while it
is open.

Who reads what: ``pipeline.DecodeStats`` (``decompress_device(...,
stats=)``, ``lz4-bench --stats``) reads the ``decode.*`` spans of its
request; ``lz4-bench --profile`` writes them all into its Chrome trace;
the benchmark's program-span readers (``lz4bench/program_trace.py``)
read the spans from the profiler's events and the ``h2d_bytes`` counter
from a recording.  The decode's counters, each a request, say what it
was handed and how it was planned: ``decode.frames`` and
``decode.blocks`` (parsed), ``decode.chains.sparse``, ``.fused``,
``.dense`` and ``.resolve`` (chains planned onto each engine) and
``decode.fused.isolated`` (chains prepared again one by one, inside the
span ``decode.plan.isolate``, after the fused prep of them all together
overflowed), read from a recording; no benchmark metric reads them
yet.  The counter ``decode.scan.arena_blocks`` (blocks the one native
scan of a many-block request wrote into the table, inside
``decode.scan.blocks``) is read by ``DecodeStats`` and ``lz4-bench
--stats`` too.  A request of raw blocks
(``pipeline.decompress_blocks_to_device``) records the span
``decode.raw`` around its front (the block table, ``decode.scan`` and
``decode.plan`` inside) and the counters ``decode.raw.blocks`` (blocks
handed in) and ``decode.raw.literal_bytes`` (literal bytes its scan
found), each a request, beside the ``decode.chains.*`` counters;
``DecodeStats`` reads the span and the literal bytes, and the
benchmark's ``raw_front_ms.decode`` times the front.  The span ``decode.dense.codes`` (inside ``decode.engine.dense``:
the staging of the mxu2 chains' columns and kernel H9's launches) and
the counter ``decode.dense.device_codes`` (substeps whose mxu2 codes the
card built, a request) are read by ``DecodeStats`` and ``lz4-bench
--stats``.  The counter ``encode.levels.kernel`` (one a block whose prefix
levels kernel H8 decided) is read from a recording, beside the blocks
encoded, by whoever asks how often the kernel took the block.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

from torch.profiler import record_function

PREFIX = "lz4tpu_torch."


class Span:
    """One span: ``start`` and ``end`` in ``time.perf_counter_ns``
    nanoseconds (``end`` is None while it is open), ``parent`` the id of
    the span it was opened in on the same thread (None: it starts a
    request), ``request`` the id of the request's first span."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start", "end")

    def __init__(self, name: str, id_: int, parent: Span | None):
        self.name = name
        self.id = id_
        self.parent = None if parent is None else parent.id
        self.request = id_ if parent is None else parent.request
        self.thread = threading.get_ident()
        self.start = 0
        self.end = None


class Recorder:
    """What one recording kept: its spans in the order they opened, and
    its counters."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def seconds(self, name: str, request: int | None = None) -> float:
        """Seconds inside the closed spans named ``name`` (of
        ``request`` only, where given), summed."""
        return sum(s.end - s.start for s in self.spans
                   if s.name == name and s.end is not None
                   and (request is None or s.request == request)) / 1e9


_NULL = contextlib.nullcontext()
_RECORDERS: tuple = ()         # the open recordings
_LOCK = threading.Lock()       # taken to open or close a recording
_IDS = itertools.count(1)
_LOCAL = threading.local()     # .stack: the thread's open spans


class _Open:
    """The context of one span while recordings are open."""

    __slots__ = ("_recs", "_name", "_span", "_range")

    def __init__(self, recs: tuple, name: str):
        self._recs = recs
        self._name = name

    def __enter__(self) -> Span:
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        s = self._span = Span(self._name, next(_IDS),
                              stack[-1] if stack else None)
        self._range = record_function(PREFIX + self._name)
        self._range.__enter__()
        stack.append(s)
        for rec in self._recs:
            rec.spans.append(s)
        s.start = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> None:
        self._span.end = time.perf_counter_ns()
        _LOCAL.stack.pop()
        self._range.__exit__(*exc)


def span(name: str):
    """A context around one layer's work, recorded where a recording is
    open; its value is the :class:`Span` (None outside recordings)."""
    recs = _RECORDERS
    if not recs:
        return _NULL
    return _Open(recs, name)


def active() -> bool:
    """Whether a recording is open: a caller whose count takes work to
    compute asks first, so that the count costs nothing outside one."""
    return bool(_RECORDERS)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of every open recording."""
    recs = _RECORDERS
    if not recs:
        return
    for rec in recs:
        rec.add(name, n)


@contextlib.contextmanager
def recording():
    """Open a :class:`Recorder` for the block and hand it out."""
    global _RECORDERS
    rec = Recorder()
    with _LOCK:
        _RECORDERS = _RECORDERS + (rec,)
    try:
        yield rec
    finally:
        with _LOCK:
            _RECORDERS = tuple(r for r in _RECORDERS if r is not rec)
