"""Pipelined decode service (port of ``lz4tpu.serve``): overlap host
preprocessing with device execution.

A decode request passes through two stages with very different
resources:

  host   frame parse -> native token scan -> classifier + host prep
         (``lz4tpu_torch.native``, C++ through ctypes, which releases
         the interpreter lock)
  device sparse programs / fused and mxu2 kernels (``lz4tpu_torch.device``)

``DecodeSession`` runs the host stage on a background thread that owns
one CUDA stream: it stages each request's prep arrays through pinned
memory without waiting for the stream, launches the kernels on it, and
records an event after the last launch.  A ticket is done once its work
is *enqueued*; ``result()`` and ``result_on_device()`` make the caller's
stream wait on that event before they touch the output.  So while the
card decodes request N the prep thread parses and packs request N+1.
Callers collect results in submission order.

Usage::

    with DecodeSession() as s:
        tickets = [s.submit(blob) for blob in blobs]
        outputs = [t.result() for t in tickets]
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from . import pipeline as pl
from . import trace
from .constants import FOR_ALL, Reservation
from .device import mxu2 as mx
from .device import to_device
from .errors import Lz4Error


class DecodeTicket:
    """Handle for one submitted buffer; ``result()`` blocks until the
    decoded bytes are ready (or re-raises the decode error with
    reference-parity diagnostics)."""

    def __init__(self, session: "DecodeSession"):
        self._session = session
        self._done = threading.Event()
        self._release_lock = threading.Lock()
        self._released = False
        self._error: BaseException | None = None
        # set by the prep thread on success:
        self._buf: np.ndarray | None = None
        self._parsed = None
        self._table = None
        self._segs: list | None = None   # [(out_lo, device tensor)]
        self._event = None               # CUDA event after the last launch
        self._faults: list = []          # mxu2 fault flags, read on join
        self._out_np: bytes | None = None
        self._out_dev = None             # cached device-resident result
        self._verified = False           # checksums checked (either path)

    # -- prep-thread side -------------------------------------------------
    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def _finish(self, buf, parsed, table, segs, event=None,
                faults=()) -> None:
        self._buf = buf
        self._parsed = parsed
        self._table = table
        self._segs = segs
        self._event = event
        self._faults = list(faults)
        self._done.set()

    # -- caller side --------------------------------------------------------
    def _release_slot_once(self) -> None:
        """Free the session's in-flight slot exactly once (result() and
        result_on_device() may race from different threads; the session
        semaphore must not be double-released)."""
        with self._release_lock:
            if self._released:
                return
            self._released = True
        self._session._slots.release()

    def _join_stream(self, tensors) -> None:
        """Order the caller's current stream after the stream that
        produced ``tensors``, and keep their memory from being handed
        out again while the caller's queued work still reads it.  The
        first join reads the decode's mxu2 fault flags (waiting for its
        launches) and raises, from then on, the host packer's error."""
        if self._event is None:
            return
        cur = torch.cuda.current_stream(self._session.device)
        cur.wait_event(self._event)
        for t in tensors:
            t.record_stream(cur)
        faults, self._faults = self._faults, []
        try:
            mx.raise_on_fault(*faults)
        except ValueError as e:
            self._error = e
            raise

    def result(self, timeout: float | None = None) -> bytes:
        if not self._done.wait(timeout):
            raise TimeoutError("decode not finished")
        self._release_slot_once()
        if self._error is not None:
            raise self._error
        if self._out_np is None:
            if self._table is None:        # empty input fast path
                self._out_np = b""
                self._verified = True
            elif self._segs is None:
                # already collected via result_on_device: fetch that
                self._join_stream([self._out_dev])
                out = self._out_dev.cpu().numpy().tobytes()
                if not self._verified:
                    # collected earlier with verify="none": settle the
                    # checksum contract now that bytes are host-side
                    self._settle(self._session._verify, out)
                    self._mark_verified()
                self._out_np = out
            else:
                self._join_stream([arr for _lo, arr in self._segs])
                out = bytearray(self._table.n_out)
                for lo, arr in self._segs:
                    seg = arr.cpu().numpy()
                    out[lo:lo + seg.size] = seg.tobytes()
                out = bytes(out)
                if not self._verified:
                    # a prior result_on_device(verify="device") may have
                    # settled the contract already (and dropped the
                    # inputs it needed) while leaving zero-output segs
                    # in place: do not verify twice
                    self._settle(self._session._verify, out)
                self._out_np = out
                self._segs = None
                self._mark_verified()
        return self._out_np

    def _settle(self, verify, out) -> None:
        """Check ``out``'s checksums with ``verify(buf, parsed, out,
        table)``; a fault goes to :meth:`DecodeSession._rederive`."""
        try:
            verify(self._buf, self._parsed, out, self._table)
        except Lz4Error as e:
            self._session._rederive(bytes(self._buf), e)

    def _mark_verified(self) -> None:
        """Checksum contract settled: drop the inputs kept for it."""
        self._verified = True
        self._buf = None
        self._parsed = None

    def result_on_device(self, timeout: float | None = None,
                         verify: str = "device") -> torch.Tensor:
        """Like result(), but the decoded bytes stay a uint8 tensor on
        the session's device (cf. ``decompress_to_device``).  verify:
        "device" (content checksums through the xxh32 kernels, no output
        fetch) or "none" (skip for now; a later result() on the same
        ticket still verifies before returning bytes).
        """
        if verify not in ("device", "none"):
            raise ValueError(
                f"result_on_device verify must be 'device' or 'none', "
                f"got {verify!r}"
            )
        if not self._done.wait(timeout):
            raise TimeoutError("decode not finished")
        self._release_slot_once()
        if self._error is not None:
            raise self._error
        dev = self._session.device

        def _verify_dev(out_dev):
            if verify == "device" and not self._verified:
                if self._table is not None:
                    self._settle(pl._verify_checksums_device, out_dev)
                self._mark_verified()

        if self._out_dev is not None:
            self._join_stream([self._out_dev])
            _verify_dev(self._out_dev)
            return self._out_dev
        if self._out_np is not None:
            # already collected as host bytes (result() or the host
            # fallback), both verified: stage those
            self._out_dev = to_device(
                np.frombuffer(self._out_np, np.uint8), dev)
            return self._out_dev
        if self._table is None or not self._segs:
            self._out_dev = torch.zeros(
                0 if self._table is None else self._table.n_out,
                dtype=torch.uint8, device=dev)
            _verify_dev(self._out_dev)
            return self._out_dev
        self._join_stream([arr for _lo, arr in self._segs])
        out_dev = pl.assemble_device_segments(
            self._segs, self._table.n_out, dev)
        if self._event is not None:
            # later collectors order themselves after the assembly
            self._event = torch.cuda.current_stream(dev).record_event()
        _verify_dev(out_dev)
        self._out_dev = out_dev
        self._segs = None
        return out_dev


class DecodeSession:
    """Two-stage pipelined decoder (host prep thread + asynchronous
    launches on the thread's own CUDA stream).  Results come back in
    submission order via tickets.

    max_inflight bounds the number of requests that have been submitted
    but whose results have not been collected yet; that is, it bounds
    the device memory held by pending outputs.  ``submit`` blocks once
    the bound is reached until a ``result()`` call frees a slot, so
    every ticket must eventually be collected.

    device: ``"cuda"`` (the default) runs the kernels and raises when
    CUDA is absent; ``"cpu"`` runs their plain PyTorch versions.
    """

    def __init__(self, reservation: Reservation = FOR_ALL,
                 max_inflight: int = 4, *, device="cuda"):
        self.reservation = Reservation(reservation)
        self.device = pl._resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue()
        self._max_inflight = max(1, max_inflight)
        self._slots = threading.BoundedSemaphore(self._max_inflight)
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._prep_loop, name="lz4tpu-prep", daemon=True
        )
        self._thread.start()

    # -- submission ---------------------------------------------------------
    def submit(self, data) -> DecodeTicket:
        self._slots.acquire()
        t = DecodeTicket(self)
        with self._lock:
            if self._closed:
                self._slots.release()
                raise RuntimeError("session closed")
            self._q.put((t, bytes(data)))
        return t

    def decode_all(self, blobs) -> list[bytes]:
        tickets = []
        outs = []
        # keep the submission window below the in-flight bound by
        # collecting the oldest result first, so this never deadlocks
        # against a blocking submit for any blob count
        for b in blobs:
            while len(tickets) >= self._max_inflight:
                outs.append(tickets.pop(0).result())
            tickets.append(self.submit(b))
        outs.extend(t.result() for t in tickets)
        return outs

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._thread.join()

    def __enter__(self) -> "DecodeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- prep thread ----------------------------------------------------------
    def _prep_loop(self) -> None:
        # the current stream is per thread: everything this thread
        # stages and launches goes to the session's stream
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            while True:
                item = self._q.get()
                if item is None:
                    return
                ticket, data = item
                try:
                    self._prep_one(ticket, data)
                except BaseException as e:          # noqa: BLE001
                    # per-request isolation: the error is the ticket's,
                    # raised to whoever collects it; the thread goes on
                    ticket._fail(e)

    def _prep_one(self, ticket: DecodeTicket, data: bytes) -> None:
        with trace.span("decode"):
            try:
                self._prep_batch(ticket, data)
            except Lz4Error as e:
                # the prep loop hands what this raises to the ticket
                self._rederive(data, e)

    def _rederive(self, data: bytes, fault: Lz4Error):
        """Stream-order fault precedence, as ``decompress_to_device``:
        the batch stages parse the whole structure before any checksum,
        so the streaming host engine re-derives the diagnostic of
        ``fault`` and raises it.  Where the host decodes ``data``
        instead, the batch stages or the device's bytes are wrong: that
        is raised, and the host's bytes are never served."""
        pl._host_fallback(data, self.reservation)
        raise RuntimeError(
            "DecodeSession: the host engine decodes a frame that the "
            f"device path rejected with {type(fault).__name__}: {fault}"
        ) from fault

    def _prep_batch(self, ticket: DecodeTicket, data: bytes) -> None:
        try:
            buf, parsed, table = pl._decode_front(data, self.reservation)
        except pl.BatchCapacityExceeded:
            # the streaming host engine fully verifies checksums itself
            ticket._out_np = pl._host_fallback(data, self.reservation)
            ticket._verified = True
            ticket._done.set()
            return
        if table is None or table.n_out == 0:
            ticket._finish(buf, parsed, table, [])
            return
        with trace.span("decode.plan"):
            plan = pl.plan_decode(buf, parsed, table)
        # Enqueue the device work (shared with decompress_to_device):
        # staging and launches do not wait for the stream, so this
        # returns once the kernels are queued and the card overlaps the
        # next request's prep.
        # the mxu2 fault flags are read by the collector, not here: the
        # next request's prep does not wait for this one's kernels.
        # The table's columns alias this thread's scan scratch: the plan
        # and the staging copies read them before this returns, and the
        # ticket reads only n_out and the frame bounds of its table.
        faults: list = []
        segs = pl.build_device_segments(buf, table, plan, self.device,
                                        faults=faults)
        event = (self._stream.record_event()
                 if self._stream is not None else None)
        ticket._finish(buf, parsed, table, segs, event, faults)

    # -- result-side checksum verification --------------------------------
    @staticmethod
    def _verify(buf, parsed, out: bytes, table) -> None:
        pl._verify_checksums(
            buf, parsed, np.frombuffer(out, np.uint8), table
        )


__all__ = ["DecodeSession", "DecodeTicket", "Lz4Error"]
