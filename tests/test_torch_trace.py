"""The port's own spans and counters (``lz4tpu_torch.trace``), on the CPU.

Inside ``recording()`` the decode and device-emit encode paths record
their layer boundaries in order, each span with its parent and its
request; outside it nothing is recorded and ``record_function`` is never
entered.  ``DecodeStats`` reads its times from the spans, and
``lz4-bench --stats`` prints the line it printed before.
"""

import dataclasses
import io
import re
import sys
import threading

import numpy as np
import pytest

import lz4tpu_torch as lt
from lz4tpu_torch import cli, device, pipeline, trace


def _text(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, int(rng.integers(2, 9)),
                          dtype=np.uint8).tobytes() for _ in range(300)]
    return b" ".join(words[i] for i in rng.integers(0, 300, n // 4))[:n]


@pytest.fixture(scope="module")
def two_blocks():
    """Zeros then text, two independent 64 KiB blocks: a sparse chain and
    a text chain, scanned apart and joined."""
    raw = bytes(65536) + _text(65536)
    return raw, lt.compress(raw, block_max_code=4, block_independence=True)


def _names(rec, skip=("stage", "stage.pin")):
    return [s.name for s in rec.spans if s.name not in skip]


def test_spans_nest_with_parent_and_request():
    with trace.recording() as rec:
        with trace.span("a") as a:
            with trace.span("a.b") as b:
                with trace.span("a.b.c") as c:
                    pass
            with trace.span("a.d") as d:
                pass
        with trace.span("e") as e:
            pass
    assert [s.name for s in rec.spans] == ["a", "a.b", "a.b.c", "a.d", "e"]
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id,
                                                         a.id)
    assert {a.request, b.request, c.request, d.request} == {a.id}
    assert e.parent is None and e.request == e.id != a.id
    assert all(s.start <= s.end for s in rec.spans)
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start
    assert d.end <= a.end <= e.start
    assert rec.seconds("a.b") == (b.end - b.start) / 1e9
    assert rec.seconds("a", request=e.id) == 0


def test_recordings_nest_and_each_gets_what_it_saw():
    with trace.recording() as outer:
        with trace.span("before"):
            pass
        trace.count("n", 2)
        with trace.recording() as inner:
            with trace.span("both"):
                trace.count("n", 3)
        with trace.span("after"):
            pass
    assert [s.name for s in outer.spans] == ["before", "both", "after"]
    assert [s.name for s in inner.spans] == ["both"]
    assert outer.counters == {"n": 5} and inner.counters == {"n": 3}
    assert trace._RECORDERS == ()


def test_off_records_nothing_and_enters_no_range(monkeypatch, two_blocks):
    raw, frame = two_blocks

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace._RECORDERS == ()
    assert trace.span("decode") is trace.span("encode") is trace._NULL
    with trace.span("decode") as s:
        assert s is None
    assert trace.count("h2d_bytes", 7) is None
    out = lt.decompress_to_device(frame, device="cpu", verify="device")
    assert bytes(out.numpy()) == raw
    assert lt.decompress(lt.compress(raw[:4096], backend="device-emit",
                                     device="cpu")) == raw[:4096]
    assert lt.decompress_device(frame, device="cpu") == raw
    assert getattr(trace._LOCAL, "stack", []) == []
    with pytest.raises(AssertionError, match="record_function"):
        with trace.recording():
            with trace.span("decode"):
                pass


def test_decode_spans_in_order(two_blocks):
    raw, frame = two_blocks
    with trace.recording() as rec:
        out = lt.decompress_to_device(frame, device="cpu", verify="device")
    assert bytes(out.numpy()) == raw
    plan = pipeline.plan_decode(
        np.frombuffer(frame, np.uint8), *_parsed_table(frame))
    text_engine = "dense" if plan.dense_chains else "fused"
    assert _names(rec) == [
        "decode", "decode.parse", "decode.scan", "decode.scan.blocks",
        "decode.scan.join", "decode.plan", "decode.engines",
        "decode.engine.sparse", f"decode.engine.{text_engine}",
        "decode.assemble", "decode.verify"]
    by_id = {s.id: s for s in rec.spans}
    root = rec.spans[0]
    assert {s.request for s in rec.spans} == {root.id}
    parents = {s.name: by_id[s.parent].name for s in rec.spans[1:]
               if s.name not in ("stage", "stage.pin")}
    assert parents == {
        "decode.parse": "decode", "decode.scan": "decode",
        "decode.scan.blocks": "decode.scan",
        "decode.scan.join": "decode.scan", "decode.plan": "decode",
        "decode.engines": "decode",
        "decode.engine.sparse": "decode.engines",
        f"decode.engine.{text_engine}": "decode.engines",
        "decode.assemble": "decode", "decode.verify": "decode"}
    # the compressed buffer staged for the sparse chain, under the engines
    stages = [s for s in rec.spans if s.name == "stage"]
    assert stages and by_id[stages[0].parent].name == "decode.engines"
    assert not any(s.name == "stage.pin" for s in rec.spans)   # the CPU


def _parsed_table(frame):
    buf = np.frombuffer(frame, np.uint8)
    parsed = pipeline.parse_frames(buf, lt.FOR_ALL)
    return parsed, pipeline.build_seq_table(buf, parsed, lt.FOR_ALL, frame)


def test_one_block_scans_without_a_join():
    raw = _text(20000, seed=3)
    frame = lt.compress(raw)
    with trace.recording() as rec:
        out = lt.decompress_to_device(frame, device="cpu", verify="host")
    assert bytes(out.numpy()) == raw
    assert _names(rec)[:5] == ["decode", "decode.parse", "decode.scan",
                               "decode.scan.blocks", "decode.plan"]
    assert "decode.scan.join" not in _names(rec)
    assert _names(rec)[-1] == "decode.verify"


def test_fallback_span_inside_the_request():
    with trace.recording() as rec:
        with pytest.raises(lt.Lz4Error):
            lt.decompress_to_device(b"\x04\x22\x4d\x18\x60\x40\x82\x05",
                                    device="cpu")
    names = _names(rec)
    assert names[0] == "decode" and "decode.fallback" in names
    fb = next(s for s in rec.spans if s.name == "decode.fallback")
    assert fb.request == rec.spans[0].id


def test_encode_spans_in_order():
    raw = _text(65536 + 2000, seed=1)           # a full block and a tail
    with trace.recording() as rec:
        frame = lt.compress(raw, block_max_code=4, backend="device-emit",
                            device="cpu")
    assert lt.decompress(frame) == raw
    block = ["encode.block", "stage", "encode.issue", "encode.grams",
             "encode.sort", "encode.levels", "encode.restore",
             "encode.combine", "encode.fetch", "encode.splice"]
    assert [s.name for s in rec.spans] == (
        ["encode"] + block * 2 + ["encode.checksum"])
    by_id = {s.id: s for s in rec.spans}
    parent = {s.name: by_id[s.parent].name for s in rec.spans[1:]}
    assert parent == {
        "encode.block": "encode", "stage": "encode.block",
        "encode.issue": "encode.block", "encode.fetch": "encode.block",
        "encode.splice": "encode.block", "encode.checksum": "encode",
        **{f"encode.{k}": "encode.issue"
           for k in ("grams", "sort", "levels", "restore", "combine")}}
    assert {s.request for s in rec.spans} == {rec.spans[0].id}


def test_h2d_bytes_counts_what_is_handed(monkeypatch):
    arrays = [np.arange(10, dtype=np.int32), np.zeros(3, np.uint8),
              np.ones((4, 5), np.int64)]
    with trace.recording() as rec:
        device.to_device(arrays[0], "cpu")
        device.to_device_packed(arrays, "cpu")
    assert rec.counters == {"h2d_bytes": 40 + 40 + 3 + 160}
    # the decode: every array the pipeline stages, and nothing else
    handed = []
    real = device.to_device

    def spy(a, dev):
        handed.append(np.ascontiguousarray(a).nbytes)
        return real(a, dev)

    raw = bytes(100000) + _text(50000, seed=2)
    frame = lt.compress(raw, block_max_code=4, block_independence=True)
    # every module's binding (the CPU's to_device_packed calls device's)
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("lz4tpu_torch")
                and getattr(mod, "to_device", None) is real):
            monkeypatch.setattr(mod, "to_device", spy)
    with trace.recording() as rec:
        out = lt.decompress_to_device(frame, device="cpu", verify="device")
    assert bytes(out.numpy()) == raw
    assert handed and rec.counters["h2d_bytes"] == sum(handed)
    assert len(frame) in handed        # the compressed buffer, once


def test_counts_from_threads_add_up():
    n_threads, n = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.recording() as rec:
            def work():
                with trace.span("t"):
                    for _ in range(n):
                        trace.count("n", 1)
                    with trace.span("t.inner"):
                        pass

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert rec.counters == {"n": n_threads * n}
    outer = {s.id: s for s in rec.spans if s.name == "t"}
    inner = [s for s in rec.spans if s.name == "t.inner"]
    assert len(outer) == len(inner) == n_threads
    assert all(outer[s.parent].thread == s.thread and s.request == s.parent
               for s in inner)


STATS_FIELDS = ["comp_bytes", "out_bytes", "n_frames", "n_blocks",
                "n_chains", "n_seqs", "engine_chains", "engine_bytes",
                "parse_s", "scan_s", "plan_s", "device_s", "verify_s",
                "dense_codes_s", "device_codes", "arena_blocks", "raw_s",
                "raw_literal_bytes"]


def test_decode_stats_from_spans(two_blocks):
    raw, frame = two_blocks
    assert [f.name for f in dataclasses.fields(pipeline.DecodeStats)] == (
        STATS_FIELDS)
    with trace.recording() as outer:
        st = pipeline.DecodeStats()
        assert lt.decompress_device(frame, device="cpu", stats=st) == raw
        # another request in the same recording leaves st as it was
        lt.decompress_device(frame, device="cpu")
    assert (st.comp_bytes, st.out_bytes, st.n_frames, st.n_blocks,
            st.n_chains, st.arena_blocks) == (len(frame), len(raw), 1, 2,
                                              2, 2)
    assert sum(st.engine_chains.values()) == 2
    assert st.raw_s == st.raw_literal_bytes == 0     # a frame request
    req = outer.spans[0]
    assert req.name == "decode"
    for stage in ("parse", "scan", "plan", "device", "verify"):
        got = getattr(st, f"{stage}_s")
        assert got == outer.seconds(f"decode.{stage}", req.request) > 0
        assert got < outer.seconds(f"decode.{stage}")
    total = (req.end - req.start) / 1e9
    assert st.parse_s + st.scan_s + st.plan_s + st.device_s + st.verify_s \
        <= total
    assert trace._RECORDERS == ()


def test_decode_stats_engines_without_plan_keep_zero_times(two_blocks):
    raw, frame = two_blocks
    for engine in ("pallas", "resolve"):
        st = pipeline.DecodeStats()
        assert lt.decompress_device(frame, engine=engine, device="cpu",
                                    stats=st) == raw
        assert st.parse_s > 0 and st.scan_s > 0
        assert st.plan_s == st.device_s == st.verify_s == 0.0


def test_stats_line_as_before(tmp_path, monkeypatch, two_blocks):
    _raw, frame = two_blocks
    path = tmp_path / "f.lz4"
    path.write_bytes(frame)
    monkeypatch.setenv(cli.DEVICE_ENV, "cpu")
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    assert cli.main(["lz4-bench", "--reps", "1", "--backend", "device",
                     "--stats", str(path)]) == 0
    lines = err.getvalue().splitlines()
    i = next(k for k, ln in enumerate(lines) if "frames=" in ln)
    assert re.fullmatch(
        r"  frames=1 blocks=2 chains=2 seqs=\d+ engines=\{.+\} "
        r"bytes=\{.+\}", lines[i])
    assert re.fullmatch(
        r"  parse=\d+\.\d\dms scan=\d+\.\d\dms plan=\d+\.\d\dms "
        r"device=\d+\.\d\dms verify=\d+\.\d\dms", lines[i + 1])
    assert trace._RECORDERS == ()
