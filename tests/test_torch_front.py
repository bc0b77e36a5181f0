"""The four decode entry points share one request front and one plan
executor, on the CPU.

``decompress_to_device``, ``decompress_device``, ``DecodeSession`` and
``dist.decompress_sharded`` parse and scan through
``pipeline._decode_front`` and run their plans through
``pipeline._stage_plan`` and ``pipeline._launch_plan``: each request is
traced as one ``decode`` span with the same layers and counters inside
it, and each entry keeps its own answer to a stream past the batched
pipeline's int32 coordinates.
"""

import numpy as np
import pytest

import lz4tpu_torch as lt
from lz4tpu_torch import dist, pipeline, trace


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    picks = rng.integers(0, 8192, n // 5 + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _src_text(n: int) -> bytes:
    from lz4tpu_torch import api, serve

    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (pipeline, dist, api, serve))
    return blob[:n]


def _mixed():
    """Independent 64 KiB blocks of fragment text and source text, then
    a frame of zeros: fused, dense and sparse chains."""
    raw = _frag_text(64 << 10, 1) + _src_text(64 << 10)
    zeros = bytes(200_000)
    return raw + zeros, (lt.compress(raw, block_max_code=4,
                                     block_independence=True)
                         + lt.compress(zeros))


def _session(data):
    with lt.DecodeSession(device="cpu") as s:
        return s.submit(data).result()


ENTRIES = {
    "decompress_to_device": lambda data: bytes(
        lt.decompress_to_device(data, device="cpu").numpy()),
    "decompress_device": lambda data: lt.decompress_device(data,
                                                           device="cpu"),
    "DecodeSession": _session,
    "decompress_sharded": lambda data: dist.decompress_sharded(
        data, dist.make_mesh(1, "cpu")),
}

FRONT = ("decode.parse", "decode.scan", "decode.plan", "decode.engines")


def _spy(monkeypatch, *steps) -> list:
    """Record each call of the pipeline's ``steps`` (in order), which
    the entries look up at the call."""
    calls = []
    for step in steps:
        real = getattr(pipeline, step)

        def spy(*a, _real=real, _step=step, **k):
            calls.append(_step)
            return _real(*a, **k)
        monkeypatch.setattr(pipeline, step, spy)
    return calls


def _traced(entry, data):
    with trace.recording() as rec:
        out = ENTRIES[entry](data)
    roots = [s for s in rec.spans if s.name == "decode"]
    assert len(roots) == 1, [s.name for s in rec.spans if s.parent is None]
    inside = [s for s in rec.spans if s.request == roots[0].id]
    return out, rec, roots[0], inside


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_every_decode_entry_traces_one_front(entry, monkeypatch):
    raw, data = _mixed()
    calls = _spy(monkeypatch, "_decode_front", "_stage_plan", "_launch_plan")
    out, rec, root, inside = _traced(entry, data)
    assert out == raw
    assert calls == ["_decode_front", "_stage_plan", "_launch_plan"]
    names = [s.name for s in inside]
    for name in FRONT:
        assert name in names, (entry, name, names)
    assert all(root.start <= s.start <= s.end <= root.end for s in inside)
    _out, want, _root, _inside = _traced("decompress_to_device", data)
    keys = ["decode.frames", "decode.blocks"] + [
        f"decode.chains.{k}" for k in ("sparse", "fused", "dense",
                                       "resolve")]
    assert {k: rec.counters.get(k) for k in keys} == {
        k: want.counters.get(k) for k in keys}
    assert want.counters["decode.frames"] == 2
    assert all(want.counters[f"decode.chains.{k}"]
               for k in ("sparse", "fused", "dense"))


def _too_big(*_a, **_k):
    raise pipeline.BatchCapacityExceeded(1 << 40)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_every_entry_answers_a_capacity_overflow(entry, monkeypatch):
    """The scan refuses the stream: ``decompress_to_device`` raises its
    ValueError, the other three serve the host engine's bytes."""
    raw, data = _mixed()
    monkeypatch.setattr(pipeline, "build_seq_table", _too_big)
    calls = _spy(monkeypatch, "_decode_front")
    before = pipeline.HOST_FALLBACKS
    if entry == "decompress_to_device":
        with pytest.raises(ValueError) as e:
            ENTRIES[entry](data)
        assert str(e.value) == (
            "decompress_to_device: stream decodes past 2**31-1 bytes, "
            "beyond the batched pipeline's int32 coordinates; split the "
            "input by frame or use the streaming host engine")
        assert pipeline.HOST_FALLBACKS == before
    else:
        assert ENTRIES[entry](data) == raw == lt.decompress_host(data)
        assert pipeline.HOST_FALLBACKS == before + 1
    assert calls == ["_decode_front"]


def test_sharded_decode_runs_the_shared_executor(monkeypatch):
    """On a one-entry CPU mesh the sharded decode stages its plan and
    then launches it through the pipeline's executor, once each, and its
    engines' spans lie under ``decode.engines`` inside its request."""
    raw, data = _mixed()
    calls = _spy(monkeypatch, "_stage_plan", "_launch_plan")
    out, _rec, _root, inside = _traced("decompress_sharded", data)
    assert out == raw
    assert calls == ["_stage_plan", "_launch_plan"]
    by_id = {s.id: s for s in inside}
    engines = {s.name for s in inside if s.name.startswith("decode.engine.")
               and by_id[s.parent].name == "decode.engines"}
    assert engines == {"decode.engine.sparse", "decode.engine.fused",
                       "decode.engine.dense"}
