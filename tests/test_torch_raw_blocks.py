"""Raw LZ4 blocks with no frame (Parquet's LZ4_RAW pages) through
``lz4tpu_torch.decompress_blocks_to_device`` on the CPU, held byte for
byte, errors included, against an engine independent of the port: the
JAX package's streaming raw-block mode (``lz4tpu.stream.Decompressor.
for_block``) and its one-shot ``lz4tpu.block.decode_block``; the stated
sizes against the JAX package's own errors; the pages against the
benchmark's plain Parquet reference (``lz4bench/reference_parquet.py``);
the port's own ``Decompressor.for_block`` against the JAX package's; the
request's counters against what the scan and the plan report; and one
request of the benchmark's cell on the card, where the JAX package is
never imported."""

import numpy as np
import pytest
import torch

import lz4tpu_torch as lt
from lz4bench import harness, reference_parquet
from lz4tpu_torch import pipeline, trace
from lz4tpu_torch.stream import Decompressor

corpus = harness.corpus("tpch_lineitem_parquet")
entry = harness._load_file(harness.HERE / "entries" / "decode_blocks.py",
                           "entry")


def _block(page, level=1) -> bytes:
    return entry.compress_block(np.frombuffer(bytes(page), np.uint8),
                                level).tobytes()


def _stream(decompressor, error, block: bytes):
    """``decompressor.for_block`` fed one block: its bytes, or the class
    name and message of the ``error`` it raised."""
    try:
        ctx = decompressor.for_block(len(block))
        out, pos = bytearray(), 0
        while pos < len(block):
            used, piece = ctx.update(block[pos:])
            out += piece
            pos += used
            if not used:
                return ("stalled", bytes(out))
        return bytes(out)
    except error as e:
        return (type(e).__name__, str(e))


def _host(block: bytes):
    """The JAX package's raw-block decode of one block: its bytes, or the
    class name and message of what it raised. Where the streaming mode
    decodes, the one-shot ``decode_block`` gives the same bytes."""
    import lz4tpu
    from lz4tpu import block as jblock

    got = _stream(lz4tpu.Decompressor, lz4tpu.Lz4Error, block)
    if isinstance(got, bytes):
        assert jblock.decode_block(block) == got
    return got


def _port_host(block: bytes):
    """The port's own ``Decompressor.for_block`` on one block."""
    return _stream(Decompressor, lt.Lz4Error, block)


def _size_error(name: str, *args):
    """Class name and message of the JAX package's error ``name``."""
    from lz4tpu import errors as jerrors

    e = getattr(jerrors, name)(*args)
    return (type(e).__name__, str(e))


def _device(blocks, out_sizes=None, **kw):
    """The entry on ``blocks``: its bytes, or the class name and message
    of what it raised."""
    sizes = [len(b) for b in blocks]
    if out_sizes is None:
        out_sizes = [len(_host(b)) for b in blocks]
    try:
        out = lt.decompress_blocks_to_device(b"".join(blocks), sizes,
                                             out_sizes, device="cpu", **kw)
    except (lt.Lz4Error, ValueError) as e:
        return (type(e).__name__, str(e))
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    return bytes(out.numpy())


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(2048)]
    return b"".join(frags[i] for i in rng.integers(0, 2048, n // 5 + 8))[:n]


@pytest.fixture(scope="module")
def row_group():
    """A row group of 3,000 lineitem rows: its pages (with what their
    headers would say) and one raw block of the frozen encoder a page."""
    t = corpus._rows.lineitem(3000, np.random.default_rng(25))
    pages = corpus.row_group(t)
    return pages, [_block(p.body) for p in pages]


def test_a_row_group_decodes_to_its_pages(row_group):
    pages, blocks = row_group
    bodies = [p.body.tobytes() for p in pages]
    assert len(pages) == 32                   # 16 chunks, no fallback
    got = _device(blocks, [len(b) for b in bodies])
    assert got == b"".join(bodies)
    assert [_host(b) for b in blocks] == bodies
    data = b"".join(blocks)
    assert reference_parquet.decode_pages(
        data, [len(b) for b in blocks], [len(b) for b in bodies]) == bodies


def test_the_pages_read_back_to_the_rows(row_group):
    """The port's answer, cut at the stated sizes, read by the reference
    into each column's values, equal to the rows."""
    pages, blocks = row_group
    sizes = [p.body.size for p in pages]
    out = _device(blocks, sizes)
    ends = np.cumsum(sizes)
    decoded = [out[e - s:e] for s, e in zip(sizes, ends)]
    t = corpus._rows.lineitem(3000, np.random.default_rng(25))
    for name, ptype, width in corpus.COLUMNS:
        got = reference_parquet.column_values(
            [(p.kind, p.n_values, d) for p, d in zip(pages, decoded)
             if p.column == name], ptype, width)
        want = t[name]
        if name == "l_comment":
            off, n = want
            want = [t["pool"][o:o + k].tobytes() for o, k in zip(off, n)]
        elif name in ("l_returnflag", "l_linestatus"):
            want = list(want)
        elif name in ("l_shipinstruct", "l_shipmode"):
            names = (corpus._rows.SHIPINSTRUCT if name == "l_shipinstruct"
                     else corpus._rows.SHIPMODE)
            want = [names[i].encode() for i in want]
        if isinstance(want, list):
            assert got == want, name
        else:
            assert np.array_equal(got, want), name


SPECIAL = {
    # a block of literals only: token, length bytes, the bytes
    "literals": lambda: bytes([0xF0, 255, 255, 2 * 0 + 30])
    + bytes(range(256)) * 2 + bytes(15 + 255 + 255 + 30 - 512),
    "zeros": lambda: _block(bytes(300_000)),
    "one_byte_out": lambda: b"\x10\x41",
    "one_byte_in": lambda: b"\x00",
    "empty": lambda: b"",
    "over_1mib": lambda: _block(_text((1 << 20) + 4099, 3)),
    "random": lambda: _block(np.random.default_rng(4).integers(
        0, 256, 70_000, dtype=np.uint8).tobytes()),
}


@pytest.mark.parametrize("name", sorted(SPECIAL))
def test_a_special_block_alone_and_among_others(name):
    block = SPECIAL[name]()
    want = _host(block)
    assert isinstance(want, bytes)
    assert _port_host(block) == want
    assert _device([block]) == want
    text = _block(_text(50_000, 9))
    assert _device([text, block, text]) == _host(text) + want + _host(text)


def test_no_blocks_decode_to_nothing():
    got = lt.decompress_blocks_to_device(b"", [], [], device="cpu")
    assert got.numel() == 0 and got.dtype == torch.uint8


def _engines(blocks) -> dict:
    with trace.recording() as rec:
        out = _device(blocks)
    assert out == b"".join(_host(b) for b in blocks)
    return {k: rec.counters[f"decode.chains.{k}"]
            for k in ("sparse", "fused", "dense", "resolve")}


@pytest.mark.parametrize("engine", ["sparse", "fused", "dense", "resolve"])
def test_blocks_forced_to_each_engine(engine, monkeypatch):
    """Each engine decodes raw blocks: zeros and literal pages plan
    sparse, text fused; with the fused engine's chain cap at nothing the
    text goes to the mxu2 engine, with the mxu2 cap too to the
    resolver."""
    if engine == "sparse":
        blocks = [SPECIAL["zeros"](), SPECIAL["literals"](),
                  SPECIAL["random"]()]
    else:
        blocks = [_block(_text(40_000, s)) for s in (1, 2)]
    if engine in ("dense", "resolve"):
        monkeypatch.setattr(pipeline, "_FUSED_MAX_CHAIN_OUT", 0)
    if engine == "resolve":
        monkeypatch.setattr(pipeline, "_DENSE_MAX_CHAIN_OUT", 1 << 10)
    got = _engines(blocks)
    assert got[engine] == len(blocks)
    assert sum(got.values()) == len(blocks)


def _before_start() -> bytes:
    """A block whose one match (offset 8) reaches 4 bytes before the
    block's start: 4 literals, then the match, then 5 literals."""
    return bytes([0x40]) + b"abcd" + bytes([8, 0]) + bytes([0x50]) + b"vwxyz"


def _cut(block: bytes, n: int) -> bytes:
    return block[:n]


ERRORS = {
    "truncated_literals": lambda t: [_cut(t, len(t) - 1)],
    "truncated_length": lambda t: [bytes([0xF0])],
    "truncated_offset": lambda t: [bytes([0x14]) + b"a" + b"\x05"],
    "before_start_first": lambda t: [_before_start()],
    "before_start_second": lambda t: [t, _before_start()],
    "offset_zero": lambda t: [bytes([0x14]) + b"a" + bytes([0, 0]) + b"\x00"],
    "match_after_last_literals": lambda t: [bytes([0x11]) + b"a"],
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_a_malformed_block_raises_what_for_block_raises(name):
    """The first block at fault raises the class and message the JAX
    package's streaming raw-block mode raises for it, on its own and
    after sound blocks; the port's own streaming mode agrees."""
    text = _block(_text(20_000, 5))
    blocks = ERRORS[name](text)
    bad = blocks[-1]
    want = _host(bad)
    assert isinstance(want, tuple) and want[0] == "DataCorruption", want
    assert _port_host(bad) == want
    n_text = len(_host(text))
    sizes = [n_text] * (len(blocks) - 1) + [0]
    assert _device(blocks, sizes) == want
    assert _device([text, text] + blocks, [n_text] * 2 + sizes) == want
    # the earlier of two faults wins
    assert _device([bad, _cut(text, 3)], [0, 0]) == want


@pytest.mark.parametrize("delta", [-1, 1, -7])
def test_a_stated_size_unlike_the_decoded_one_raises(delta):
    """The stated size is held both ways against the length the JAX
    package decodes, the first block at fault raising the JAX package's
    error for the bytes short or the excess, never padded or cut."""
    blocks = [_block(_text(10_000, 7)), _block(bytes(5000))]
    n = [len(_host(b)) for b in blocks]
    got = _device(blocks, [n[0], n[1] + delta])
    if delta < 0:
        assert got == _size_error("err_content_size_exceeded")
    else:
        assert got == _size_error("err_content_size_leftover", delta)
    assert _device(blocks, [n[0] + delta, n[1] + delta]) == got


@pytest.mark.parametrize("sizes,message", [
    (([10, 10], [1, 1]), "the blocks' compressed sizes add up to 20 bytes, "
     "past the 15 of data"),
    (([5], [1, 1]), "1 comp_sizes but 2 out_sizes"),
    (([-1, 16], [0, 0]), "comp_sizes holds a negative size"),
    (([15], [-3]), "out_sizes holds a negative size"),
])
def test_sizes_that_do_not_fit_the_data_raise(sizes, message):
    with pytest.raises(ValueError) as e:
        lt.decompress_blocks_to_device(bytes(15), *sizes, device="cpu")
    assert str(e.value) == message


def test_numpy_input_and_no_host_fallback(row_group):
    _pages, blocks = row_group
    before = pipeline.HOST_FALLBACKS
    data = np.frombuffer(b"".join(blocks), np.uint8)
    sizes = [len(b) for b in blocks]
    out = lt.decompress_blocks_to_device(
        data, sizes, [len(_host(b)) for b in blocks], device="cpu")
    assert bytes(out.numpy()) == b"".join(_host(b) for b in blocks)
    assert pipeline.HOST_FALLBACKS == before


def test_counters_are_what_the_scan_and_the_plan_report(row_group):
    """``decode.raw.blocks``, ``decode.raw.literal_bytes`` and the
    ``decode.chains.*`` counters of one request against the scan's table
    and the plan of the same blocks; the front's spans nest as the frame
    front's; ``DecodeStats`` reads them."""
    pages, blocks = row_group
    data = b"".join(blocks)
    comp = [len(b) for b in blocks]
    out = [p.body.size for p in pages]
    st = pipeline.DecodeStats()
    with trace.recording() as rec:
        lt.decompress_blocks_to_device(data, comp, out, device="cpu",
                                       stats=st)
    _buf, table, plan = pipeline._raw_front(data, comp, out)
    want = {"decode.raw.blocks": len(blocks),
            "decode.scan.arena_blocks": len(blocks),
            "decode.raw.literal_bytes": int(table.lit_len.sum()),
            "decode.chains.sparse": len(plan.sparse),
            "decode.chains.fused": len(plan.fused_chains),
            "decode.chains.dense": len(plan.dense_chains),
            "decode.chains.resolve": len(plan.other)}
    assert {k: rec.counters[k] for k in want} == want
    assert sum(want[f"decode.chains.{k}"] for k in
               ("sparse", "fused", "dense", "resolve")) == len(blocks)
    assert want["decode.raw.literal_bytes"] < sum(out)
    by_id = {s.id: s for s in rec.spans}
    parent = {s.name: by_id[s.parent].name for s in rec.spans
              if s.parent is not None and s.name.startswith("decode.")}
    assert parent["decode.raw"] == "decode"
    assert parent["decode.scan"] == parent["decode.plan"] == "decode.raw"
    assert parent["decode.scan.blocks"] == "decode.scan"
    assert "decode.parse" not in parent
    assert st.n_blocks == len(blocks) and st.out_bytes == sum(out)
    assert st.raw_literal_bytes == want["decode.raw.literal_bytes"]
    assert st.raw_s >= st.scan_s + st.plan_s > 0
    assert st.engine_chains == {k: v for k, v in (
        (k, want[f"decode.chains.{k}"]) for k in ("sparse", "fused",
                                                  "dense", "resolve")) if v}


def test_the_front_is_the_frame_entries_scan_and_executor(row_group,
                                                          monkeypatch):
    """One call of the raw front, the shared scan, the planner, and the
    executor's two steps; no frame parse."""
    pages, blocks = row_group
    calls = []
    for step in ("_raw_front", "_scan_rows", "plan_decode", "_stage_plan",
                 "_launch_plan", "parse_frames", "_decode_front"):
        real = getattr(pipeline, step)

        def spy(*a, _real=real, _step=step, **k):
            calls.append(_step)
            return _real(*a, **k)
        monkeypatch.setattr(pipeline, step, spy)
    _device(blocks, [p.body.size for p in pages])
    assert calls == ["_raw_front", "_scan_rows", "plan_decode",
                     "_stage_plan", "_launch_plan"]


@pytest.mark.cuda
def test_a_request_of_the_cell_on_the_card():
    """One request of the benchmark's cell (two whole row groups) on the
    card, its answer fetched to the host and held against the plain
    reference's decode of the same blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell("parquet-lineitem-rg1m")
    requests = harness.make_requests(cell, 3250000025)[:1]
    e = entry.Entry(requests, cell.config, cell.traffic,
                    torch.device("cuda"))
    before = pipeline.HOST_FALLBACKS
    out = e.call(0)
    torch.cuda.synchronize()
    got = bytes(out.cpu().numpy())
    pages = reference_parquet.decode_pages(e.joined[0], e.comp_sizes[0],
                                           e.out_sizes[0])
    assert got == b"".join(pages)
    assert got == bytes(e.refs[0].cpu().numpy())
    assert pipeline.HOST_FALLBACKS == before
