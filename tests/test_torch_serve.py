"""lz4tpu_torch.DecodeSession held against lz4tpu.serve.DecodeSession on
the CPU: the same blobs, made from seeds, through both sessions give
equal bytes from ``result()`` and ``result_on_device()``, equal
exception class names and messages on bad frames, and the same ticket
and slot behaviour.  ``device="cpu"`` runs every kernel's plain version;
the JAX session runs with ``interpret=True``.  Tolerance 0.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu.device import fused as jfu
from lz4tpu.serve import DecodeSession as JaxSession
from lz4tpu_torch import serve as tserve
from lz4tpu_torch.serve import DecodeSession, DecodeTicket


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    picks = rng.integers(0, 8192, n // 5 + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _src_text(n: int) -> bytes:
    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (jfu, jpl, lz4tpu.api))
    return blob[:n]


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _session(**kw) -> DecodeSession:
    return DecodeSession(device="cpu", **kw)


def _jax_bytes(arr) -> bytes:
    return np.asarray(jax.device_get(arr)).tobytes()


#: name -> (payload, compress options): one per engine and framing
BLOBS = {
    "zeros": (bytes(700_000), {}),
    "stored": (_rand(120_000, 1), {}),
    "fused": (_frag_text(150_000, 2), {}),
    "mxu2": (_src_text(90_000), {}),
    "independent": (_frag_text(200_000, 3),
                    dict(block_max_code=4, block_independence=True)),
    "checksums": (_frag_text(130_000, 4),
                  dict(block_checksum=True, content_size=True,
                       block_max_code=4)),
    "legacy": (_frag_text(100_000, 5), dict(frame_format="legacy")),
    "empty-frame": (b"", {}),
}


@pytest.mark.parametrize("name", sorted(BLOBS))
def test_result_matches_jax_session(name):
    payload, kw = BLOBS[name]
    data = lz4tpu.compress(payload, **kw)
    with _session() as s, JaxSession(interpret=True) as j:
        assert s.submit(data).result() == j.submit(data).result() == payload


@pytest.mark.parametrize("name", sorted(BLOBS))
@pytest.mark.parametrize("verify", ["device", "none"])
def test_result_on_device_matches_jax_session(name, verify):
    payload, kw = BLOBS[name]
    data = lz4tpu.compress(payload, **kw)
    with _session() as s, JaxSession(interpret=True) as j:
        t = s.submit(data)
        arr = t.result_on_device(verify=verify)
        assert arr.dtype == torch.uint8 and arr.ndim == 1
        assert arr.device.type == "cpu"
        want = _jax_bytes(j.submit(data).result_on_device(verify=verify))
        assert arr.numpy().tobytes() == want == payload
        # repeated and mixed collection stays consistent
        assert t.result_on_device(verify=verify) is arr
        assert t.result() == payload
        assert t._verified and t._buf is None


def test_bytes_first_then_device():
    payload, kw = BLOBS["fused"]
    data = lz4tpu.compress(payload, **kw)
    with _session() as s:
        t = s.submit(data)
        assert t.result() == payload
        arr = t.result_on_device()
        assert arr.numpy().tobytes() == payload
        assert t.result_on_device() is arr


def test_decode_all_and_submission_order():
    names = sorted(BLOBS)
    blobs = [lz4tpu.compress(BLOBS[n][0], **BLOBS[n][1]) for n in names]
    with _session(max_inflight=3) as s:
        outs = s.decode_all(blobs)
    assert outs == [BLOBS[n][0] for n in names]
    with JaxSession(max_inflight=3, interpret=True) as j:
        assert j.decode_all(blobs) == outs


def test_compressed_roundtrips_interleaved_sizes():
    rng = np.random.default_rng(17)
    payloads = []
    for k in range(12):
        n = int(rng.integers(0, 50000))
        if k % 3 == 0:
            p = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        elif k % 3 == 1:
            p = (b"the quick brown fox %d " % k) * (n // 20 + 1)
        else:
            p = b"\x00" * n
        payloads.append(p)
    blobs = [lz4tpu_torch.compress(p) for p in payloads]
    # max_inflight >= len(blobs): all may be submitted before any
    # collection, so out-of-order collection can be exercised
    with _session(max_inflight=len(blobs)) as s:
        tickets = [s.submit(b) for b in blobs]
        for i in reversed(range(len(tickets))):
            assert tickets[i].result() == payloads[i], i


def test_session_survives_many_submissions():
    data = lz4tpu_torch.compress(bytes(1000))
    with _session(max_inflight=2) as s:
        assert s.decode_all([data] * 25) == [bytes(1000)] * 25


def _bad_frames():
    payload = _frag_text(130_000, 4)
    good = lz4tpu.compress(payload, block_checksum=True, block_max_code=4)
    block = bytearray(good)
    block[300] ^= 0x20                  # inside block 0, under its checksum
    content = bytearray(good)
    content[-1] ^= 0x01                 # the content checksum
    magic = bytearray(good)
    magic[0] ^= 0xFF
    return {
        "block-checksum": bytes(block),
        "content-checksum": bytes(content),
        "bad-magic": bytes(magic),
        "truncated": good[:len(good) // 2],
        "garbage": b"not an lz4 frame at all",
    }, good, payload


@pytest.mark.parametrize("what", ["block-checksum", "content-checksum",
                                  "bad-magic", "truncated", "garbage"])
def test_errors_match_jax_session_and_do_not_poison(what):
    bad, good, payload = _bad_frames()
    data = bad[what]
    with _session() as s, JaxSession(interpret=True) as j:
        t_before = s.submit(good)
        t_bad = s.submit(data)
        t_after = s.submit(good)
        with pytest.raises(lz4tpu.errors.Lz4Error) as ej:
            j.submit(data).result()
        with pytest.raises(lz4tpu_torch.Lz4Error) as et:
            t_bad.result()
        assert type(et.value).__name__ == type(ej.value).__name__
        assert str(et.value) == str(ej.value)
        # the same error again, and through the device collector
        with pytest.raises(type(et.value)):
            t_bad.result()
        with pytest.raises(type(et.value)):
            t_bad.result_on_device()
        assert t_before.result() == payload
        assert t_after.result() == payload


@pytest.mark.parametrize("what", ["block-checksum", "content-checksum"])
def test_result_on_device_verify_contract(what):
    """A corrupted checksum surfaces however the ticket is collected:
    verify="device" raises at once; verify="none" defers, and a later
    result() still raises."""
    bad, _good, payload = _bad_frames()
    data = bad[what]
    with _session() as s, JaxSession(interpret=True) as j:
        with pytest.raises(lz4tpu.errors.Lz4Error) as ej:
            j.submit(data).result_on_device()
        with pytest.raises(lz4tpu_torch.ChecksumError) as et:
            s.submit(data).result_on_device()
        assert (type(et.value).__name__, str(et.value)) == (
            type(ej.value).__name__, str(ej.value))
        t = s.submit(data)
        arr = t.result_on_device(verify="none")
        assert arr.shape[0] == len(payload)   # bytes delivered unverified
        with pytest.raises(lz4tpu_torch.ChecksumError) as et2:
            t.result()
        assert str(et2.value) == str(et.value)


def test_deferred_verify_settles_on_host_result():
    payload, kw = BLOBS["checksums"]
    data = lz4tpu.compress(payload, **kw)
    calls = []
    with _session() as s:
        real = s._verify
        s._verify = lambda *a: (calls.append(1), real(*a))
        t = s.submit(data)
        t.result_on_device(verify="none")
        assert not t._verified and not calls
        assert t.result() == payload
        assert t._verified and len(calls) == 1
        assert t.result() == payload and len(calls) == 1


def test_no_double_verify_after_device_verify(monkeypatch):
    """result_on_device(verify="device") settles the contract; the
    result() that follows does not verify again."""
    payload, kw = BLOBS["checksums"]
    data = lz4tpu.compress(payload, **kw)
    dev_calls, host_calls = [], []
    real_dev = tpl._verify_checksums_device
    monkeypatch.setattr(
        tpl, "_verify_checksums_device",
        lambda *a, **k: (dev_calls.append(1), real_dev(*a, **k)))
    with _session() as s:
        real = s._verify
        s._verify = lambda *a: (host_calls.append(1), real(*a))
        t = s.submit(data)
        t.result_on_device(verify="device")
        t.result_on_device(verify="device")
        assert len(dev_calls) == 1
        assert t.result() == payload
        assert not host_calls


def test_bad_verify_mode():
    with _session() as s, JaxSession(interpret=True) as j:
        t = s.submit(lz4tpu.compress(b"x"))
        tj = j.submit(lz4tpu.compress(b"x"))
        with pytest.raises(ValueError) as ej:
            tj.result_on_device(verify="host")
        with pytest.raises(ValueError, match="'device' or 'none'") as et:
            t.result_on_device(verify="host")
        assert str(et.value) == str(ej.value)
        assert t.result() == b"x" == tj.result()


@pytest.mark.parametrize("data", [b"", lz4tpu.compress(b"")],
                         ids=["no-bytes", "empty-frame"])
def test_empty_input(data):
    with _session() as s:
        assert s.submit(data).result() == b""
        t = s.submit(data)
        arr = t.result_on_device()
        assert arr.shape == (0,) and arr.dtype == torch.uint8
        assert t.result() == b""
        t = s.submit(data)
        assert t.result() == b""
        assert t.result_on_device().shape == (0,)


def test_result_is_idempotent():
    payload, kw = BLOBS["mxu2"]
    with _session() as s:
        t = s.submit(lz4tpu.compress(payload, **kw))
        first = t.result()
        assert first == payload
        assert t.result() is first


def test_submit_after_close_raises():
    s = _session()
    s.close()
    s.close()  # idempotent
    with pytest.raises(RuntimeError, match="session closed"):
        s.submit(b"")
    assert not s._thread.is_alive()
    # the refused submit gave its slot back
    assert s._slots.acquire(blocking=False)


def test_context_manager_closes():
    with _session() as s:
        assert s.submit(b"").result() == b""
    assert s._closed and not s._thread.is_alive()


def test_without_cuda_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeSession()
    assert lz4tpu_torch.DecodeSession is tserve.DecodeSession


def test_submit_blocks_at_inflight_bound():
    data = lz4tpu_torch.compress(bytes(1000))
    with _session(max_inflight=2) as s:
        t1, t2 = s.submit(data), s.submit(data)
        state = {}

        def third():
            state["t3"] = s.submit(data)
            state["done"] = True

        th = threading.Thread(target=third, daemon=True)
        th.start()
        time.sleep(0.3)
        assert "done" not in state       # blocked at the bound
        assert t1.result() == bytes(1000)    # frees a slot
        th.join(timeout=10)
        assert not th.is_alive() and state.get("done")
        assert t2.result() == bytes(1000)
        assert state["t3"].result() == bytes(1000)


def test_result_timeout():
    with _session() as s:
        gate = threading.Event()
        real = s._prep_one

        def slow(ticket, data):
            gate.wait(10)
            real(ticket, data)

        s._prep_one = slow
        t = s.submit(lz4tpu_torch.compress(b"abc"))
        with pytest.raises(TimeoutError, match="decode not finished"):
            t.result(timeout=0.0)
        with pytest.raises(TimeoutError, match="decode not finished"):
            t.result_on_device(timeout=0.01)
        gate.set()
        assert t.result(timeout=10) == b"abc"


class _Slots:
    def __init__(self):
        self.released = 0
        self._lock = threading.Lock()

    def release(self):
        with self._lock:
            self.released += 1


class _Sess:
    device = torch.device("cpu")

    def __init__(self):
        self._slots = _Slots()


def test_ticket_timeout_and_error_paths():
    """A never-finishing ticket times out without releasing its slot; a
    failed ticket re-raises through both collectors and releases once."""
    sess = _Sess()
    t = DecodeTicket(sess)
    with pytest.raises(TimeoutError, match="not finished"):
        t.result_on_device(timeout=0.01)
    assert sess._slots.released == 0
    t._fail(lz4tpu_torch.DataCorruption("boom"))
    with pytest.raises(lz4tpu_torch.DataCorruption, match="boom"):
        t.result_on_device()
    with pytest.raises(lz4tpu_torch.DataCorruption, match="boom"):
        t.result(timeout=1)
    assert sess._slots.released == 1


def test_slot_released_once_under_two_collecting_threads():
    """result() and result_on_device() racing from two threads on many
    tickets: every slot is released exactly once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sess = _Sess()
        tickets = [DecodeTicket(sess) for _ in range(200)]
        for t in tickets:
            t._finish(np.zeros(0, np.uint8), None, None, [])
        start = threading.Barrier(2)
        errors = []

        def collect(method):
            start.wait(10)
            try:
                for t in tickets:
                    getattr(t, method)(timeout=5)
            except Exception as e:      # noqa: BLE001 - reported below
                errors.append(e)

        ths = [threading.Thread(target=collect, args=(m,), daemon=True)
               for m in ("result", "result_on_device")]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
            assert not th.is_alive()
        assert not errors
        assert sess._slots.released == len(tickets)
    finally:
        sys.setswitchinterval(old)


def test_bounded_semaphore_never_over_released():
    """The live session's BoundedSemaphore raises on a release too many;
    collecting each ticket twice, both ways, must not trip it."""
    data = lz4tpu_torch.compress(_frag_text(20_000, 9))
    with _session(max_inflight=2) as s:
        for _ in range(6):
            t = s.submit(data)
            t.result_on_device(verify="none")
            t.result()
            t.result_on_device()
        # every slot is back: two submits go through without blocking
        a, b = s.submit(data), s.submit(data)
        assert a.result() == b.result()


def test_capacity_fallback(monkeypatch):
    """BatchCapacityExceeded tickets deliver the host engine's output,
    verified, through both collectors."""
    payload, kw = BLOBS["checksums"]
    data = lz4tpu.compress(payload, **kw)

    def boom(*a, **k):
        raise tpl.BatchCapacityExceeded(1 << 40)

    monkeypatch.setattr(tpl, "build_seq_table", boom)
    with _session() as s:
        t = s.submit(data)
        arr = t.result_on_device()
        assert arr.numpy().tobytes() == payload
        assert t._verified and t._table is None
        assert t.result() == payload
        t = s.submit(data)
        assert t.result() == payload
        # a corrupt frame through the fallback raises the host engine's
        # error on its ticket
        bad = bytearray(data)
        bad[-1] ^= 0x01
        with pytest.raises(lz4tpu_torch.ChecksumError) as et:
            s.submit(bytes(bad)).result()
        with pytest.raises(lz4tpu_torch.ChecksumError) as eh:
            lz4tpu_torch.decompress_host(bytes(bad))
        assert str(et.value) == str(eh.value)


def test_launch_counter_is_safe_under_threads(monkeypatch):
    """_kernels.launch counts under a lock: launches from many threads
    (the session's prep thread and its callers) lose no update."""
    import contextlib
    import types

    from lz4tpu_torch import _kernels

    fake = types.SimpleNamespace(lz4t_block_fill=lambda *a: 0)
    monkeypatch.setattr(_kernels, "lib", lambda: fake)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_kernels, "LAUNCHES", dict(_kernels.LAUNCHES))
    _kernels.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def many():
            for _ in range(2000):
                _kernels.launch("block_fill", "lz4t_block_fill", "cuda")

        ths = [threading.Thread(target=many, daemon=True) for _ in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert _kernels.LAUNCHES["block_fill"] == 16000
    _kernels.reset_launches()
    assert set(_kernels.LAUNCHES.values()) == {0}
