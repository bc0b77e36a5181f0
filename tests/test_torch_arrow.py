"""Arrow IPC / Feather V2 record batches of TPC-H lineitem, one LZ4 frame a
buffer (the benchmark's ``arrow-lz4frame`` configuration), through the
port's decode on the CPU, held against the benchmark's plain reference;
and the decode's counters of frames, blocks and planned chains."""

import json
import pathlib

import numpy as np
import pytest

import lz4tpu_torch as lt
from lz4bench import encoder, harness, reference
from lz4tpu_torch import pipeline, trace
from lz4tpu_torch.device import fused as fu

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "lz4bench/configs/arrow-lz4frame.json")
                    .read_text())
FLAGS = CONFIG["frame"]


@pytest.fixture(scope="module")
def lineitem():
    """Two record batches of 1,024 rows: their buffers and one frame of
    the frozen encoder a buffer, at the configuration's flags."""
    corpus = harness.corpus("tpch_lineitem")
    t = corpus.lineitem(2048, np.random.default_rng(21))
    bufs = corpus.batch_buffers(t, 0, 1024) + corpus.batch_buffers(
        t, 1024, 2048)
    frames = [encoder.compress_frame(b, FLAGS, CONFIG["level"], workers=1)
              for b in bufs]
    return bufs, frames


def _plan(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    parsed = pipeline.parse_frames(buf, lt.FOR_ALL)
    table = pipeline.build_seq_table(buf, parsed, lt.FOR_ALL, data)
    return parsed, pipeline.plan_decode(buf, parsed, table)


def test_batches_decode_to_their_buffers(lineitem):
    bufs, frames = lineitem
    assert len(frames) == 2 * len(harness.corpus("tpch_lineitem").BUFFERS)
    want = np.concatenate(bufs).tobytes()
    out = lt.decompress_to_device(b"".join(frames), device="cpu",
                                  verify="device")
    assert bytes(out.numpy()) == want
    assert b"".join(reference.read_frame(f).content for f in frames) == want
    for b, f in zip(bufs, frames):
        assert reference.read_frame(f).content == b.tobytes()
        one = lt.decompress_to_device(f, device="cpu", verify="device")
        assert bytes(one.numpy()) == b.tobytes()


def test_counters_are_what_parse_and_plan_report(lineitem):
    _bufs, frames = lineitem
    data = b"".join(frames)
    parsed, plan = _plan(data)
    with trace.recording() as rec:
        lt.decompress_to_device(data, device="cpu", verify="device")
    planned = {"sparse": len(plan.sparse), "fused": len(plan.fused_chains),
               "dense": len(plan.dense_chains), "resolve": len(plan.other)}
    assert sum(planned.values()) == len(frames)      # one chain a frame
    want = {"decode.frames": len(parsed.frames),
            "decode.blocks": sum(len(f.blocks) for f in parsed.frames),
            **{f"decode.chains.{k}": v for k, v in planned.items()}}
    assert {k: rec.counters[k] for k in want} == want
    assert want["decode.frames"] == len(frames)
    # the text chains overflowed the fused prep together and alone
    assert rec.counters["decode.fused.isolated"] == planned["dense"] > 0
    assert planned["fused"] == 0


def test_the_one_scan_counts_the_blocks_it_wrote(lineitem):
    """``decode.scan.arena_blocks``: every block of a many-frame request,
    scanned by the one native call straight into the table; none on a
    one-block request (the single-block scan); ``DecodeStats`` reads
    it."""
    _bufs, frames = lineitem
    data = b"".join(frames)
    parsed, _ = _plan(data)
    n_blocks = sum(len(f.blocks) for f in parsed.frames)
    assert n_blocks >= len(frames) > 1
    with trace.recording() as rec:
        lt.decompress_to_device(data, device="cpu", verify="device")
    assert rec.counters["decode.scan.arena_blocks"] == \
        rec.counters["decode.blocks"] == n_blocks
    st = pipeline.DecodeStats()
    assert lt.decompress_device(data, device="cpu", stats=st) == \
        b"".join(bytes(b) for b in _bufs)
    assert st.arena_blocks == st.n_blocks == n_blocks
    one = lt.compress(frames[0] * 3)
    with trace.recording() as rec:
        lt.decompress_to_device(one, device="cpu", verify="device")
    assert rec.counters["decode.blocks"] == 1
    assert rec.counters.get("decode.scan.arena_blocks", 0) == 0


def _text_frames(n_frames: int) -> tuple:
    """Frames of fragment text that the fused engine takes, one chain
    each."""
    raws = [harness.corpus("frag").make(60000, np.random.default_rng(i))
            .tobytes() for i in range(n_frames)]
    return raws, [lt.compress(r, block_max_code=4) for r in raws]


def test_a_fused_overflow_isolates_every_chain(monkeypatch):
    raws, frames = _text_frames(3)
    data = b"".join(frames)
    with trace.recording() as rec:
        out = lt.decompress_to_device(data, device="cpu", verify="device")
    assert bytes(out.numpy()) == b"".join(raws)
    assert rec.counters["decode.chains.fused"] == 3
    assert "decode.fused.isolated" not in rec.counters
    assert "decode.plan.isolate" not in [s.name for s in rec.spans]
    # the second chain overflows the fused budgets, alone as with others
    parsed, _ = _plan(data)
    buf = np.frombuffer(data, np.uint8)
    table = pipeline.build_seq_table(buf, parsed, lt.FOR_ALL, data)
    bad = pipeline._chains_of(table)[1]
    real = fu.prep_fused

    def prep(*args, chain_ranges=None, **kwargs):
        if (bad.seq_lo, bad.seq_hi) in chain_ranges:
            raise fu.FusedOverflow("in-substep patches (budget)")
        return real(*args, chain_ranges=chain_ranges, **kwargs)

    monkeypatch.setattr(fu, "prep_fused", prep)
    with trace.recording() as rec:
        out = lt.decompress_to_device(data, device="cpu", verify="device")
    assert bytes(out.numpy()) == b"".join(raws)
    assert rec.counters["decode.fused.isolated"] == 3
    assert (rec.counters["decode.chains.fused"],
            rec.counters["decode.chains.dense"]) == (2, 1)
    by_id = {s.id: s for s in rec.spans}
    isolate = [s for s in rec.spans if s.name == "decode.plan.isolate"]
    assert len(isolate) == 1 and by_id[isolate[0].parent].name == \
        "decode.plan"


def test_counters_cost_nothing_outside_a_recording(monkeypatch, lineitem):
    """Outside a recording no count reaches a recorder, no span opens and
    no range is entered (``count`` and ``span`` return at once)."""
    bufs, frames = lineitem

    def refuse(*args, **kwargs):
        raise AssertionError("recorded outside a recording")

    for obj, attr in ((trace.Recorder, "add"), (trace, "_Open"),
                      (trace, "record_function")):
        monkeypatch.setattr(obj, attr, refuse)
    assert trace.active() is False
    data = b"".join(frames)
    want = np.concatenate(bufs).tobytes()
    out = lt.decompress_to_device(data, device="cpu", verify="device")
    assert bytes(out.numpy()) == want
    assert lt.decompress_device(data, device="cpu") == want
    with lt.DecodeSession(device="cpu") as s:
        assert s.submit(data).result() == want


def test_the_host_stages_run_on_one_thread_unless_asked(monkeypatch,
                                                        lineitem):
    """One worker thread by default; LZ4TPU_PACK_THREADS asks for more,
    and the request decodes to the same bytes on four."""
    from lz4tpu_torch import native

    bufs, frames = lineitem
    data = b"".join(frames)
    monkeypatch.delenv("LZ4TPU_PACK_THREADS", raising=False)
    assert native.pack_threads() == 1
    one = lt.decompress_to_device(data, device="cpu", verify="device")
    monkeypatch.setenv("LZ4TPU_PACK_THREADS", "4")
    assert native.pack_threads() == 4
    four = lt.decompress_to_device(data, device="cpu", verify="device")
    assert bytes(one.numpy()) == bytes(four.numpy()) == \
        np.concatenate(bufs).tobytes()
