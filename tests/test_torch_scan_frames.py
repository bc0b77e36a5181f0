"""The token scan of a many-block request in one native call
(``native.scan_frames``, ``pipeline.build_seq_table``'s many-block
path), held against ``lz4tpu.pipeline.build_seq_table`` on the CPU.

The table must equal the JAX package's column for column, with the same
``n_out``, ``frame_out_start`` and block spans; every fault must raise
the same class with the same message (``BatchCapacityExceeded`` with the
same argument) at the same block.  The columns of a request path alias
the scanning thread's scratch, so a ``DecodeSession`` with requests in
flight and a caller-owned table are checked beside them.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch as lt
import lz4tpu_torch.pipeline as tpl
from lz4bench import encoder, harness
from lz4tpu_torch import native
from lz4tpu_torch.xxh32 import xxh32

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "lz4bench/configs/arrow-lz4frame.json")
                    .read_text())


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(4096)]
    picks = rng.integers(0, 4096, n // 5 + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _noise(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _frame(blocks, indep: bool = False, content_size=None) -> bytes:
    """A modern frame of raw block payloads ``[(payload, compressed)]``,
    64 KiB blocks, no checksum."""
    flg = 0x40 | (0x20 if indep else 0) | (0x08 if content_size is not None
                                           else 0)
    desc = bytes([flg, 4 << 4])
    if content_size is not None:
        desc += content_size.to_bytes(8, "little")
    out = b"\x04\x22\x4d\x18" + desc + bytes([(xxh32(desc) >> 8) & 0xFF])
    for payload, compressed in blocks:
        word = len(payload) | (0 if compressed else 1 << 31)
        out += word.to_bytes(4, "little") + payload
    return out + bytes(4)


def _blocks(frame: bytes) -> list:
    """A frame's blocks as ``[(payload, compressed)]``."""
    buf = np.frombuffer(frame, np.uint8)
    return [(frame[b.comp_off:b.comp_off + b.comp_len], b.is_compressed)
            for b in tpl.parse_frames(buf, lt.FOR_ALL).blocks]


@pytest.fixture(scope="module")
def lineitem() -> bytes:
    """Two record batches of 4,096 rows of lineitem, one frame of the
    frozen encoder a buffer, at the arrow-lz4frame configuration."""
    corpus = harness.corpus("tpch_lineitem")
    t = corpus.lineitem(8192, np.random.default_rng(24))
    bufs = corpus.batch_buffers(t, 0, 4096) + corpus.batch_buffers(
        t, 4096, 8192)
    return b"".join(encoder.compress_frame(b, CONFIG["frame"],
                                           CONFIG["level"], workers=1)
                    for b in bufs)


def _mixed() -> bytes:
    """Frames whose blocks mix compressed text and stored noise."""
    a = _text(150_000, 1) + _noise(70_000, 2) + _text(90_000, 3)
    b = _noise(20_000, 4) + _text(140_000, 5)
    return (lt.compress(a, block_max_code=4)
            + lt.compress(b, block_max_code=4, block_independence=True)
            + lt.compress(_noise(5000, 6)) + lt.compress(b"")
            + lt.compress(_text(3000, 7)))


def _lying() -> bytes:
    """A linked frame whose B.Indep flag claims independence, between
    two honest frames."""
    linked = lt.compress(_text(200_000, 8), block_max_code=4,
                         content_checksum=False)
    return (lt.compress(_text(70_000, 9), block_max_code=4,
                        block_independence=True)
            + _frame(_blocks(linked), indep=True)
            + lt.compress(_text(80_000, 10), block_max_code=4))


def _request(name: str, lineitem=None) -> bytes:
    return lineitem if name == "lineitem" else {"mixed": _mixed,
                                                "lying": _lying}[name]()


def _tables(data: bytes, pooled: bool):
    buf = np.frombuffer(data, np.uint8)
    got = tpl.build_seq_table(buf, tpl.parse_frames(buf, lt.FOR_ALL),
                              lt.FOR_ALL, data, pooled_cols=pooled)
    want = jpl.build_seq_table(buf, jpl.parse_frames(buf, lz4tpu.FOR_ALL),
                               lz4tpu.FOR_ALL, data)
    return got, want


def _assert_same_table(got, want) -> None:
    for f in ("out_start", "lit_len", "lit_src", "match_len", "match_off"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.n_out == want.n_out
    np.testing.assert_array_equal(got.frame_out_start, want.frame_out_start)
    assert ([dataclasses.astuple(s) for s in got.spans]
            == [dataclasses.astuple(s) for s in want.spans])
    assert got.pre is None


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("name", ["lineitem", "mixed", "lying"])
def test_one_call_table_equals_jax(name, pooled, lineitem):
    data = _request(name, lineitem)
    got, want = _tables(data, pooled)
    _assert_same_table(got, want)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lt.FOR_ALL)
    blocks = parsed.blocks
    assert len(parsed.frames) > 2 and len(blocks) > len(parsed.frames)
    if name == "lineitem":
        assert len(parsed.frames) == 2 * len(
            harness.corpus("tpch_lineitem").BUFFERS)
    if name == "mixed":
        assert {b.is_compressed for b in blocks} == {True, False}
    if name == "lying":
        # the lying frame is demoted to linked chains, the honest
        # independent frame before it is not
        indep = {s.frame_id: s.independent for s in got.spans}
        assert indep == {0: True, 1: False, 2: False}
        assert parsed.frames[1].block_independence
    assert bytes(lt.decompress_to_device(data, device="cpu").numpy()) == \
        lz4tpu.decompress_host(data)


def _raised(fn) -> tuple:
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value), e.value.args


def _both_raise(data: bytes) -> tuple:
    """The port's and the JAX package's ``build_seq_table`` on ``data``:
    (class name, message, args) of what each raises."""
    buf = np.frombuffer(data, np.uint8)

    def ours():
        tpl.build_seq_table(buf, tpl.parse_frames(buf, lt.FOR_ALL),
                            lt.FOR_ALL, data, pooled_cols=True)

    def theirs():
        jpl.build_seq_table(buf, jpl.parse_frames(buf, lz4tpu.FOR_ALL),
                            lz4tpu.FOR_ALL, data)

    return _raised(ours), _raised(theirs)


def _three_frames(third: bytes) -> bytes:
    return (lt.compress(_text(100_000, 11), block_max_code=4)
            + lt.compress(_noise(3000, 12), block_max_code=4) + third
            + lt.compress(_text(90_000, 13), block_max_code=4))


@pytest.mark.parametrize("fault", ["offset_zero", "truncated",
                                   "match_after_literals"])
def test_a_malformed_block_mid_third_frame_raises_as_jax(fault):
    blocks = _blocks(lt.compress(_text(260_000, 14), block_max_code=4,
                                 content_checksum=False))
    assert len(blocks) == 4 and all(c for _p, c in blocks)
    payload = bytearray(blocks[2][0])
    if fault == "offset_zero":
        # the first sequence's offset, after its literals
        lit = payload[0] >> 4
        assert lit < 15 and payload[0] & 0x0F < 15
        payload[1 + lit:3 + lit] = b"\x00\x00"
    elif fault == "truncated":
        payload = payload[:len(payload) // 2]
    else:
        # a last literal run whose token still asks for a match
        payload = bytearray(b"\x1fA")
    blocks[2] = (bytes(payload), True)
    data = _three_frames(_frame(blocks))
    ours, theirs = _both_raise(data)
    assert ours[:2] == theirs[:2]
    assert ours[0] == "DataCorruption"
    with pytest.raises(lz4tpu.Lz4Error) as ref:
        lz4tpu.decompress_host(data)
    assert ours[1] == str(ref.value)


def test_a_match_before_its_frame_start_raises_as_jax():
    """The second block of a linked frame, alone in a frame of its own:
    its matches reach into the block it no longer follows."""
    blocks = _blocks(lt.compress(_text(100_000, 15), block_max_code=4,
                                 content_checksum=False))
    assert len(blocks) == 2
    data = _three_frames(_frame(blocks[1:]))
    ours, theirs = _both_raise(data)
    assert ours[:2] == theirs[:2] and ours[0] == "DataCorruption"


@pytest.mark.parametrize("delta", [-1, 1])
def test_content_size_over_and_under_raise_as_jax(delta):
    raw = _text(150_000, 16)
    third = _frame(_blocks(lt.compress(raw, block_max_code=4)),
                   content_size=len(raw) + delta)
    ours, theirs = _both_raise(_three_frames(third))
    assert ours[:2] == theirs[:2] and ours[0] == "DataCorruption"
    assert ("exceeds" in ours[1]) == (delta < 0)


def _capacity_request() -> bytes:
    return (lt.compress(_text(150_000, 17), block_max_code=4)
            + lt.compress(_noise(140_000, 18), block_max_code=4)
            + lt.compress(_text(70_000, 19), block_max_code=4))


@pytest.mark.parametrize("lim_at", np.linspace(0.0, 1.0, 17).tolist())
def test_batch_capacity_raises_as_jax(lim_at, monkeypatch):
    """``_BATCH_MAX_OUT`` set small, at 17 points of the request's
    coordinates: the same ``BatchCapacityExceeded`` at the same
    coordinate, or the same table past the end."""
    data = _capacity_request()
    n_out = len(lz4tpu.decompress_host(data))
    lim = int(lim_at * (max(n_out, len(data)) + 2))
    monkeypatch.setattr(tpl, "_BATCH_MAX_OUT", lim)
    monkeypatch.setattr(jpl, "_BATCH_MAX_OUT", lim)
    if lim >= max(n_out, len(data)):
        got, want = _tables(data, True)
        _assert_same_table(got, want)
        return
    ours, theirs = _both_raise(data)
    assert ours == theirs and ours[0] == "BatchCapacityExceeded"
    assert ours[2][0] > lim


def test_input_coordinate_capacity_comes_first():
    """Stored noise sits further into the input than into the output:
    a limit between the two stops at the input coordinate."""
    data = (lt.compress(_noise(100_000, 21), block_max_code=4)
            + lt.compress(_text(70_000, 22), block_max_code=4))
    buf = np.frombuffer(data, np.uint8)
    blk = tpl.parse_frames(buf, lt.FOR_ALL).blocks[1]
    assert not blk.is_compressed and blk.comp_len == 100_000 - 65536
    lim = blk.comp_off + blk.comp_len - 1
    assert 100_000 <= lim
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpl, "_BATCH_MAX_OUT", lim)
        mp.setattr(jpl, "_BATCH_MAX_OUT", lim)
        ours, theirs = _both_raise(data)
    assert ours == theirs
    assert ours[2] == (blk.comp_off + blk.comp_len,)


@pytest.mark.parametrize("into", [1, 100, 5000])
@pytest.mark.parametrize("frame", [0, 2])
def test_a_malformed_block_across_the_limit_raises_its_fault(frame, into,
                                                             monkeypatch):
    """The limit falls inside a block whose grammar breaks further on:
    the block's malformation comes first, as the per-block scan found
    it, not the coordinate."""
    blocks = _blocks(lt.compress(_text(260_000, 23), block_max_code=4,
                                 content_checksum=False))
    sound = _frame(blocks)
    blocks[2] = (blocks[2][0][:len(blocks[2][0]) // 2], True)
    if frame == 0:
        data = _frame(blocks) + _three_frames(b"")
        sound += _three_frames(b"")
    else:
        data, sound = _three_frames(_frame(blocks)), _three_frames(sound)
    table, _ = _tables(sound, False)
    lim = [s.out_lo for s in table.spans if s.frame_id == frame][2] + into
    monkeypatch.setattr(tpl, "_BATCH_MAX_OUT", lim)
    monkeypatch.setattr(jpl, "_BATCH_MAX_OUT", lim)
    ours, theirs = _both_raise(data)
    assert ours[:2] == theirs[:2] and ours[0] == "DataCorruption"


def test_no_coordinate_past_the_limit_is_written():
    """A limit inside a compressed block: the scan stops at that block,
    reports its grammar's total and reach, and writes no output
    coordinate above the limit anywhere in the scratch."""
    data = lt.compress(_text(300_000, 20), block_max_code=4)
    buf = np.frombuffer(data, np.uint8)
    blocks = np.array([(b.comp_off, b.comp_len, b.is_compressed)
                       for b in tpl.parse_frames(buf, lt.FOR_ALL).blocks],
                      np.int64)
    done, status, full, cols = native.scan_frames(buf, blocks, 1 << 31)
    assert (done, status) == (len(blocks), native.OK)
    starts = cols[0].copy()
    lim = int(starts[full[:2, 0].sum() + 100])      # inside block 2
    for c in native._scan_arena.cols:
        c.fill(0)
    done, status, res, cols = native.scan_frames(buf, blocks, lim)
    assert (done, status) == (2, native.E_COORD_RANGE)
    assert cols[0].size == full[:2, 0].sum()
    np.testing.assert_array_equal(cols[0], starts[:cols[0].size])
    np.testing.assert_array_equal(res[:3, 1:], full[:3, 1:])
    assert int(native._scan_arena.cols[0].max()) <= lim


def test_a_session_with_requests_in_flight_decodes_each(lineitem):
    """Four requests in flight on one prep thread, whose scans share
    its scratch: each ticket decodes to its own bytes, on the host and
    on the device."""
    other = _mixed()
    want = {lineitem: lz4tpu.decompress_host(lineitem),
            other: lz4tpu.decompress_host(other)}
    order = [lineitem, other, other, lineitem]
    with lt.DecodeSession(max_inflight=4, device="cpu") as s:
        tickets = [s.submit(d) for d in order]
        assert tickets[0].result() == want[lineitem]
        assert bytes(tickets[1].result_on_device().numpy()) == want[other]
        assert tickets[2].result() == want[other]
        assert tickets[3].result() == want[lineitem]


def test_an_owned_table_outlives_the_next_scan(lineitem):
    data = _mixed()
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lt.FOR_ALL)
    owned = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data)
    pooled = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data,
                                 pooled_cols=True)
    assert np.shares_memory(pooled.lit_len, native._scan_arena.cols[1])
    kept = {f: getattr(owned, f).copy() for f in ("out_start", "lit_len",
                                                  "lit_src", "match_len",
                                                  "match_off")}
    lbuf = np.frombuffer(lineitem, np.uint8)
    tpl.build_seq_table(lbuf, tpl.parse_frames(lbuf, lt.FOR_ALL),
                        lt.FOR_ALL, lineitem, pooled_cols=True)
    for f, v in kept.items():
        assert not np.shares_memory(getattr(owned, f),
                                    native._scan_arena.cols[0])
        np.testing.assert_array_equal(getattr(owned, f), v)
