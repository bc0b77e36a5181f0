"""The lineitem corpus and the many-frame decode entry: deterministic
inputs that keep TPC-H's rules, frames of the frozen encoder that the
plain reference decodes to their buffers, and a check that catches a
wrong answer.  CPU only, at small sizes."""

import time

import numpy as np
import pytest
import torch

from lz4bench import control, harness, reference

CELL = "tpch-lineitem-1m"
SMALL = 64 << 10
corpus = harness.corpus("tpch_lineitem")
frames_entry = harness._load_file(harness.HERE / "entries"
                                  / "decode_frames.py", "entry")


def _cell() -> harness.Cell:
    return harness.load_cell(CELL)


def _make(seed: int, stream: int = 0, n: int = 4 * SMALL) -> np.ndarray:
    return corpus.make(n, harness.generator(seed, "tpch_lineitem", stream))


def test_same_seed_same_bytes():
    a = _make(2**31 + 3)
    assert np.array_equal(a, _make(2**31 + 3))
    assert not np.array_equal(a, _make(2**31 + 4))
    assert not np.array_equal(a, _make(2**31 + 3, stream=1))


def _columns(raw: np.ndarray) -> dict:
    """The body read back into columns (every batch joined); strings as
    lists of bytes."""
    bufs = frames_entry.split(raw)
    per = len(corpus.BUFFERS)
    assert len(bufs) % per == 0
    cols = {}
    for i in range(0, len(bufs), per):
        got = {}
        for (name, kind), b in zip(corpus.BUFFERS, bufs[i:i + per]):
            if kind == "decimal128":
                v = b.view("<i8").reshape(-1, 2)
                assert not v[:, 1].any()           # non-negative, < 2**63
                got[name] = v[:, 0]
            elif kind == "offsets":
                got[name] = b.view("<i4")
            elif kind == "data":
                off = got[name]
                data = b.tobytes()
                assert off[0] == 0 and off[-1] == len(data)
                got[name] = [data[lo:hi] for lo, hi in zip(off, off[1:])]
            else:
                got[name] = b.view({"int64": "<i8"}.get(kind, "<i4"))
        for name, v in got.items():
            cols.setdefault(name, []).append(v)
    return {n: (sum(v, []) if isinstance(v[0], list) else np.concatenate(v))
            for n, v in cols.items()}


def test_the_rows_keep_the_tpch_rules():
    rows = 3000
    raw = corpus.make(rows * corpus.ROW_BYTES,
                      harness.generator(7, "tpch_lineitem", 0))
    c = _columns(raw)
    assert all(len(v) == rows for v in c.values())
    line, okey = c["l_linenumber"], c["l_orderkey"]
    assert line.min() == 1 and line.max() <= 7
    assert ((okey - 1) % 32 < 8).all() and okey[0] == 1
    # a new order starts exactly where the line number goes back to 1
    assert np.array_equal(np.diff(okey) != 0, line[1:] == 1)
    assert (np.diff(okey) >= 0).all()
    part, supp = c["l_partkey"], c["l_suppkey"]
    assert part.min() >= 1 and part.max() <= 200_000
    s = 10_000
    cands = [(part + i * (s // 4 + (part - 1) // s)) % s + 1
             for i in range(4)]
    assert np.any([supp == x for x in cands], axis=0).all()
    qty = c["l_quantity"]
    assert (qty % 100 == 0).all() and qty.min() >= 100 and qty.max() <= 5000
    retail = 90_000 + (part // 10) % 20_001 + 100 * (part % 1000)
    assert np.array_equal(c["l_extendedprice"], qty // 100 * retail)
    assert c["l_discount"].min() >= 0 and c["l_discount"].max() <= 10
    assert c["l_tax"].min() >= 0 and c["l_tax"].max() <= 8
    ship, commit, receipt = (c["l_shipdate"], c["l_commitdate"],
                             c["l_receiptdate"])
    assert (receipt > ship).all() and (receipt - ship <= 30).all()
    assert ship.min() > corpus.STARTDATE and commit.min() >= \
        corpus.STARTDATE + 30
    status = np.array(c["l_linestatus"])
    flag = np.array(c["l_returnflag"])
    assert np.array_equal(status == b"O", ship > corpus.CURRENTDATE)
    assert set(status) == {b"O", b"F"}
    assert np.array_equal(flag == b"N", receipt > corpus.CURRENTDATE)
    assert set(flag[receipt <= corpus.CURRENTDATE]) == {b"R", b"A"}
    assert set(c["l_shipinstruct"]) == {s.encode()
                                        for s in corpus.SHIPINSTRUCT}
    assert set(c["l_shipmode"]) == {s.encode() for s in corpus.SHIPMODE}
    n = np.array([len(x) for x in c["l_comment"]])
    assert n.min() >= 10 and n.max() <= 43
    pool = corpus.text_pool(np.random.default_rng(0), 1 << 16).tobytes()
    assert pool[:1] != b" " and b"  " not in pool


def test_batches_have_the_published_shape():
    raw = _make(11, n=(corpus.BATCH_ROWS + 100) * corpus.ROW_BYTES)
    bufs = frames_entry.split(raw)
    per = len(corpus.BUFFERS)
    assert len(bufs) == 2 * per
    sizes = {corpus.BUFFERS[i]: b.size for i, b in enumerate(bufs[:per])}
    rows = corpus.BATCH_ROWS
    assert sizes[("l_orderkey", "int64")] == 8 * rows
    assert sizes[("l_linenumber", "int32")] == 4 * rows
    assert sizes[("l_tax", "decimal128")] == 16 * rows
    assert sizes[("l_shipdate", "date32")] == 4 * rows
    assert sizes[("l_comment", "offsets")] == 4 * (rows + 1)
    assert sizes[("l_returnflag", "data")] == rows
    assert bufs[per].size == 8 * 100          # the last batch's keys
    # every prefix is the buffer's length, every buffer padded to 8
    pos = 0
    for b in bufs:
        assert int(raw[pos:pos + 8].view("<i8")[0]) == b.size
        pos += 8 + b.size + (-b.size) % 8
    assert pos == raw.size


def test_stream_one_follows_stream_zero():
    rows = 4000
    okeys = []
    for stream in (0, 1):
        c = _columns(corpus.make(rows * corpus.ROW_BYTES, harness.generator(
            5, "tpch_lineitem", stream)))
        okeys.append(c["l_orderkey"])
    first = rows // 4
    assert okeys[0][0] == 1
    assert okeys[1][0] == (first // 8) * 32 + first % 8 + 1


@pytest.mark.parametrize("mode", ["alter", "half"])
def test_the_check_catches_a_wrong_answer(monkeypatch, mode):
    import lz4tpu_torch

    real = lz4tpu_torch.decompress_to_device
    monkeypatch.setattr(lz4tpu_torch, "decompress_to_device",
                        control._decode_fault(mode, real))
    out = harness.run(_cell(), 2**31 + 11, 0.3, False, "cpu",
                      time.perf_counter(), size=SMALL)
    assert out["correct"] is False
    assert set(out["checks"]) == {"wrong_bytes", "failed"}
    assert out["checks"]["wrong_bytes"]["value"] > 0
    assert out["checks"]["failed"]["value"] == 0


def _entry(seed=3, size=SMALL):
    cell = _cell()
    requests = harness.make_requests(cell, seed, size)
    assert all(r.frame is None for r in requests)
    return harness.entry_class(cell.traffic["entry"])(
        requests, cell.config, cell.traffic, torch.device("cpu"))


def test_each_frame_decodes_to_its_buffer_by_the_reference():
    """The frozen encoder at the configuration's flags and level against
    the plain reference, frame by frame; and a flipped byte is seen."""
    entry = _entry()
    flags = _cell().config["frame"]
    for bufs, frames in zip(entry.buffers, entry.frames):
        for b, f in zip(bufs, frames):
            assert reference.check_frame(f, b, flags, 0) == {
                "header": 0, "content": 0, "checksum": 0}
    bad = bytearray(entry.frames[1][20])     # the comments' text
    bad[len(bad) // 2] ^= 0x55
    got = reference.check_frame(bytes(bad), entry.buffers[1][20], flags, 0)
    assert got["content"] == 1


def test_a_request_is_its_buffers_frame_by_frame():
    entry = _entry()
    per = len(corpus.BUFFERS)
    for r, bufs, frames, joined, ref in zip(
            entry.requests, entry.buffers, entry.frames, entry.joined,
            entry.refs):
        assert len(bufs) == len(frames) == per
        assert joined == b"".join(frames)
        assert bytes(ref.numpy()) == b"".join(b.tobytes() for b in bufs)
        assert ref.numel() < r.raw.size        # no prefixes, no padding
    assert entry.raw_bytes(0) == entry.refs[0].numel()
    assert entry.comp_bytes(1, None) == len(entry.joined[1])
