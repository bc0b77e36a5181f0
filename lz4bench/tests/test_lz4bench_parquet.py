"""The Parquet lineitem corpus and the raw-block decode entry:
deterministic pages that keep the writer's rules (the hybrid encoder,
the 1 MiB page cut, the dictionary fallback), pages that read back to
the rows through the plain reference, blocks of the frozen encoder that
the reference decodes to their pages, pages that pyarrow's own writer
writes byte for byte, and a check that catches a wrong answer.  CPU
only, at small sizes but for row groups of 300,000 and 1,048,576
rows."""

import time

import numpy as np
import pytest
import torch

from lz4bench import control, harness, reference_parquet

CELL = "parquet-lineitem-rg1m"
SMALL = 64 << 10
corpus = harness.corpus("tpch_lineitem_parquet")
frames_entry = harness._load_file(harness.HERE / "entries"
                                  / "decode_frames.py", "entry")


def _make(seed: int, stream: int = 0, rows: int = 2000) -> np.ndarray:
    return corpus.make(rows * corpus.ROW_BYTES, harness.generator(
        seed, "tpch_lineitem_parquet", stream))


def test_same_seed_same_pages():
    a = _make(2**31 + 3)
    assert np.array_equal(a, _make(2**31 + 3))
    assert not np.array_equal(a, _make(2**31 + 4))
    assert not np.array_equal(a, _make(2**31 + 3, stream=1))


def _table(rows: int, seed: int = 7, stream: int = 0) -> tuple:
    rng = harness.generator(seed, "tpch_lineitem_parquet", stream)
    t = corpus._rows.lineitem(rows, rng, first_order=stream * (rows // 4))
    return t, corpus.row_group(t)


def _want(t: dict, name: str):
    col = t[name]
    if name == "l_comment":
        off, n = col
        return [t["pool"][o:o + k].tobytes() for o, k in zip(off, n)]
    if name in ("l_returnflag", "l_linestatus"):
        return list(col)
    if name in ("l_shipinstruct", "l_shipmode"):
        names = (corpus._rows.SHIPINSTRUCT if name == "l_shipinstruct"
                 else corpus._rows.SHIPMODE)
        return [names[i].encode() for i in col]
    return col


@pytest.mark.parametrize("rows", [1, 2999, 40_000])
def test_pages_read_back_to_the_rows(rows):
    """Every column chunk's pages, read by the reference, are the rows
    of ``tpch_lineitem``; at 40,000 rows ``l_comment`` has fallen back."""
    t, pages = _table(rows)
    assert [p.column for p in pages if p.kind == "dictionary"] == [
        c[0] for c in corpus.COLUMNS]
    for name, ptype, width in corpus.COLUMNS:
        got = reference_parquet.column_values(
            [(p.kind, p.n_values, p.body.tobytes()) for p in pages
             if p.column == name], ptype, width)
        want = _want(t, name)
        if isinstance(want, list):
            assert got == want, name
        else:
            assert np.array_equal(got, want), name
    kinds = {p.kind for p in pages if p.column == "l_comment"}
    assert ("plain" in kinds) == (rows == 40_000)


def test_the_request_is_the_pages_laid_out_as_buffers():
    t, pages = _table(2000)
    raw = corpus.make(2000 * corpus.ROW_BYTES, harness.generator(
        7, "tpch_lineitem_parquet", 0))
    bodies = frames_entry.split(raw)
    assert [b.tobytes() for b in bodies] == [p.body.tobytes() for p in pages]


def test_a_request_is_row_groups_of_the_writer_s_size(monkeypatch):
    """Rows past ``ROW_GROUP_ROWS`` start the next row group: its own
    dictionaries and pages, over the next rows of the same table."""
    monkeypatch.setattr(corpus, "ROW_GROUP_ROWS", 1500)
    t, _pages = _table(3500)
    bodies = [b.tobytes() for b in frames_entry.split(corpus.make(
        3500 * corpus.ROW_BYTES, harness.generator(
            7, "tpch_lineitem_parquet", 0)))]
    want = []
    for lo, hi in ((0, 1500), (1500, 3000), (3000, 3500)):
        want += [p.body.tobytes() for p in corpus.row_group(
            corpus._slice(t, lo, hi))]
    assert bodies == want and len(want) == 3 * 32


@pytest.fixture(scope="module")
def big():
    """One row group of 300,000 rows: ``l_partkey``,
    ``l_extendedprice`` and ``l_comment`` fall back, ``l_comment``'s
    PLAIN pages are cut at 1 MiB."""
    return _table(300_000, seed=2**31 + 25)


def test_the_dictionary_falls_back_after_the_batch_that_fills_it(big):
    t, pages = big
    fell = set()
    for name, _ptype, _w in corpus.COLUMNS:
        chunk = [p for p in pages if p.column == name]
        vals = corpus.columns(t)[name]
        size = vals.entry_bytes()
        mask, _index = corpus._first_seen(vals, vals.n)
        dict_bytes = np.cumsum(np.where(mask, size, 0))
        n_dict = sum(p.n_values for p in chunk if p.kind == "indices")
        assert chunk[0].kind == "dictionary"
        assert chunk[0].n_values == int(mask[:n_dict].sum())
        if any(p.kind == "plain" for p in chunk):
            fell.add(name)
            assert n_dict % corpus.WRITE_BATCH == 0
            assert dict_bytes[n_dict - 1] >= corpus.DICT_LIMIT
            assert dict_bytes[n_dict - 1 - corpus.WRITE_BATCH] \
                < corpus.DICT_LIMIT
            assert chunk[0].body.size == dict_bytes[n_dict - 1]
        else:
            assert n_dict == vals.n
            assert dict_bytes[-1] < corpus.DICT_LIMIT
        kinds = [p.kind for p in chunk[1:]]
        assert kinds == sorted(kinds, key=["indices", "plain"].index)
    assert fell == {"l_partkey", "l_extendedprice", "l_comment"}


def test_pages_are_cut_after_the_batch_that_reaches_1_mib(big):
    """PLAIN pages by their bytes, index pages by the encoder's
    estimate, each at the bit width of the dictionary's size then."""
    t, pages = big
    cuts = 0
    for name, _ptype, _w in corpus.COLUMNS:
        chunk = [p for p in pages if p.column == name]
        vals = corpus.columns(t)[name]
        size = vals.entry_bytes()
        mask, _index = corpus._first_seen(vals, vals.n)
        entries = np.cumsum(mask)
        lo = 0
        data = chunk[1:]
        for k, p in enumerate(data):
            hi = lo + p.n_values
            last = k + 1 == len(data) or data[k + 1].kind != p.kind
            if p.kind == "plain":
                est = lambda a, b: int(size[a:b].sum())  # noqa: E731
            else:
                width = corpus.bit_width(int(entries[hi - 1]))
                est = lambda a, b: corpus.dict_estimate(  # noqa: E731
                    b - a, corpus.bit_width(int(entries[b - 1])))
                levels = corpus.def_levels(p.n_values)
                assert p.body[len(levels)] == width
            if not last:
                cuts += 1
                assert hi % corpus.WRITE_BATCH == 0
                assert est(lo, hi) >= corpus.PAGE_SIZE
                assert est(lo, hi - corpus.WRITE_BATCH) < corpus.PAGE_SIZE
            lo = hi
        assert lo == vals.n
    assert cuts == 7       # l_comment's PLAIN pages (6), l_suppkey's


def _rle_encoder(values, width) -> bytes:
    """parquet-cpp's ``RleEncoder`` (Put, FlushBufferedValues, Flush),
    value by value, for small inputs."""
    out = bytearray()
    st = {"cur": 0, "rep": 0, "buf": [], "lit": 0, "ind": None}
    vbytes = (width + 7) // 8

    def pack(vals):
        bits = 0
        for i, v in enumerate(vals):
            bits |= v << (i * width)
        return bits.to_bytes(width, "little")

    def flush_literal(update):
        if st["ind"] is None:
            st["ind"] = len(out)
            out.append(0)
        for g in range(0, len(st["buf"]), 8):
            out.extend(pack(st["buf"][g:g + 8]))
        st["buf"] = []
        if update:
            out[st["ind"]] = ((st["lit"] // 8) << 1) | 1
            st["ind"] = None
            st["lit"] = 0

    def flush_repeated():
        if st["lit"]:
            raise AssertionError("a repeated run inside a literal run")
        v = st["rep"] << 1
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
        out.extend(st["cur"].to_bytes(vbytes, "little"))
        st["rep"] = 0
        st["buf"] = []

    def flush_buffered():
        if st["rep"] >= 8:
            st["buf"] = []
            if st["lit"]:
                flush_literal(True)
            return
        st["lit"] += len(st["buf"])
        flush_literal(st["lit"] // 8 + 1 >= 64)
        st["rep"] = 0

    for v in values:
        if v == st["cur"]:
            st["rep"] += 1
            if st["rep"] > 8:
                continue
        else:
            if st["rep"] >= 8:
                flush_repeated()
            st["rep"] = 1
            st["cur"] = v
        st["buf"].append(v)
        if len(st["buf"]) == 8:
            flush_buffered()
    if st["lit"] or st["rep"] or st["buf"]:
        all_repeat = st["lit"] == 0 and (st["rep"] == len(st["buf"])
                                         or not st["buf"])
        if st["rep"] and all_repeat:
            flush_repeated()
        else:
            st["buf"] += [0] * (-len(st["buf"]) % 8)
            st["lit"] += len(st["buf"])
            flush_literal(True)
    return bytes(out)


def _arrow_table(t: dict):
    """The rows of ``t`` as the Arrow table whose Parquet file the
    configuration models: lineitem's Arrow types."""
    import pyarrow as pa

    rows = corpus._rows
    cols = {}
    for name, ptype, _w in corpus.COLUMNS:
        col = t[name]
        if ptype == "INT64":
            cols[name] = pa.array(col.astype(np.int64))
        elif name == "l_linenumber":
            cols[name] = pa.array(col.astype(np.int32))
        elif ptype == "FIXED_LEN_BYTE_ARRAY":      # decimal128(15,2)
            v = col.astype(np.int64)
            raw = np.stack([v, v >> 63], 1).astype("<i8").tobytes()
            cols[name] = pa.Array.from_buffers(
                pa.decimal128(15, 2), v.size, [None, pa.py_buffer(raw)])
        elif ptype == "INT32":
            cols[name] = pa.array(col.astype(np.int32)).cast(pa.date32())
        else:
            cols[name] = pa.array([bytes(v) if isinstance(v, bytes) else v
                                   for v in _want(t, name)],
                                  pa.binary()).cast(pa.string())
    return pa.table(cols)


def _varint(b: bytes, p: int) -> tuple:
    v = shift = 0
    while True:
        v |= (b[p] & 0x7F) << shift
        shift += 7
        p += 1
        if not b[p - 1] & 0x80:
            return v, p


def _thrift(b: bytes, p: int, kind: int = 12) -> tuple:
    """One value of Thrift's compact protocol at ``p``: a struct as a
    dict of its field ids; integers unzigzagged."""
    if kind in (1, 2):
        return kind == 1, p
    if kind == 3:
        return b[p], p + 1
    if kind in (4, 5, 6):
        v, p = _varint(b, p)
        return (v >> 1) ^ -(v & 1), p
    if kind == 7:
        return None, p + 8
    if kind == 8:
        n, p = _varint(b, p)
        return b[p:p + n], p + n
    if kind in (9, 10):
        n, elem = b[p] >> 4, b[p] & 0xF
        p += 1
        if n == 15:
            n, p = _varint(b, p)
        out = []
        for _ in range(n):
            v, p = _thrift(b, p, elem)
            out.append(v)
        return out, p
    assert kind == 12, kind
    out, fid = {}, 0
    while b[p]:
        delta, elem = b[p] >> 4, b[p] & 0xF
        p += 1
        if delta:
            fid += delta
        else:
            fid, p = _thrift(b, p, 4)
        out[fid], p = _thrift(b, p, elem)
    return out, p + 1


def _file_pages(path) -> dict:
    """Each column chunk's pages of a one-row-group Parquet file: (kind,
    values, body), from the page headers (PageHeader: 1 type, 3
    compressed size, 5 data page header, 7 dictionary page header)."""
    import pyarrow.parquet as pq

    data = path.read_bytes()
    group = pq.ParquetFile(path).metadata.row_group(0)
    out = {}
    for i in range(group.num_columns):
        cc = group.column(i)
        p = (cc.dictionary_page_offset if cc.has_dictionary_page
             else cc.data_page_offset)
        end = p + cc.total_compressed_size
        pages = []
        while p < end:
            head, p = _thrift(data, p)
            if head[1] == 2:
                kind, n = "dictionary", head[7][1]
            else:
                kind = "indices" if head[5][2] == 8 else "plain"
                n = head[5][1]
            pages.append((kind, n, data[p:p + head[3]]))
            p += head[3]
        out[cc.path_in_schema] = pages
    return out


@pytest.mark.parametrize("rows", [3000, corpus.ROW_GROUP_ROWS])
def test_pyarrow_writes_these_very_pages(rows, tmp_path):
    """pyarrow's own writer, on the same rows, writes these pages byte
    for byte (kinds, counts of values, bodies) with its defaults but one:
    the cap of 20,000 rows a page that later releases than the modelled
    one added (``max_rows_per_page``) is lifted. At a whole row group
    the dictionary falls back in four columns, index pages are cut by
    the estimate, and PLAIN pages at 1 MiB."""
    pq = pytest.importorskip("pyarrow.parquet")
    t, pages = _table(rows, seed=2**31 + 211)
    path = tmp_path / "lineitem.parquet"
    pq.write_table(_arrow_table(t), path, compression="none",
                   max_rows_per_page=1 << 30, write_statistics=False,
                   write_page_index=False)
    theirs = _file_pages(path)
    for name, _ptype, _w in corpus.COLUMNS:
        mine = [(p.kind, p.n_values, p.body.tobytes()) for p in pages
                if p.column == name]
        assert mine == theirs[name], name
    if rows == corpus.ROW_GROUP_ROWS:
        kinds = {(p.column, p.kind) for p in pages}
        assert {c for c, k in kinds if k == "plain"} == {
            "l_orderkey", "l_partkey", "l_extendedprice", "l_comment"}
        assert sum(p.kind == "indices" for p in pages) > 16
        assert sum(p.kind == "plain" for p in pages) > 40


@pytest.mark.parametrize("seed", range(12))
def test_the_hybrid_is_rle_encoders(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    k = int(rng.integers(1, 6))
    runs = rng.integers(1, [3, 12, 40][seed % 3], n)
    vals = np.repeat(rng.integers(0, k, n), runs)[:n]
    width = max(1, int(k - 1).bit_length())
    assert corpus.hybrid(vals, width) == _rle_encoder(vals.tolist(), width)
    got, end = reference_parquet.hybrid(corpus.hybrid(vals, width), 0,
                                        width, n)
    assert np.array_equal(got, vals)


def _cell() -> harness.Cell:
    return harness.load_cell(CELL)


def _entry(seed=3, size=SMALL):
    cell = _cell()
    requests = harness.make_requests(cell, seed, size)
    assert all(r.frame is None for r in requests)
    return harness.entry_class(cell.traffic["entry"])(
        requests, cell.config, cell.traffic, torch.device("cpu"))


def test_each_block_decodes_to_its_page_by_the_reference():
    """The frozen encoder at the configuration's level against the plain
    reference, page by page; and a flipped byte or a wrong stated size
    is seen."""
    entry = _entry()
    for k in range(len(entry.requests)):
        pages = reference_parquet.decode_pages(
            entry.joined[k], entry.comp_sizes[k], entry.out_sizes[k])
        assert pages == [p.tobytes() for p in entry.pages[k]]
        assert len(entry.joined[k]) == int(entry.comp_sizes[k].sum())
        assert entry.refs[k].numel() == int(entry.out_sizes[k].sum())
    sizes = entry.out_sizes[0].copy()
    sizes[3] += 1
    with pytest.raises(reference_parquet.PageError):
        reference_parquet.decode_pages(entry.joined[0], entry.comp_sizes[0],
                                       sizes)
    bad = bytearray(entry.joined[0])
    lo = int(entry.comp_sizes[0][:-1].sum())   # the comments' text
    bad[lo + (len(bad) - lo) // 2] ^= 0x55
    pages = reference_parquet.decode_pages(bytes(bad), entry.comp_sizes[0],
                                           entry.out_sizes[0])
    assert pages[-1] != entry.pages[0][-1].tobytes()


@pytest.mark.parametrize("mode", ["alter", "half"])
def test_the_check_catches_a_wrong_answer(monkeypatch, mode):
    import lz4tpu_torch

    real = lz4tpu_torch.decompress_blocks_to_device
    monkeypatch.setattr(lz4tpu_torch, "decompress_blocks_to_device",
                        control._decode_fault(mode, real))
    out = harness.run(_cell(), 2**31 + 11, 0.3, False, "cpu",
                      time.perf_counter(), size=SMALL)
    assert out["correct"] is False
    assert set(out["checks"]) == {"wrong_bytes", "failed"}
    assert out["checks"]["wrong_bytes"]["value"] > 0
    assert out["checks"]["failed"]["value"] == 0


def test_a_program_without_the_entry_fails_the_cell(monkeypatch):
    import lz4tpu_torch

    monkeypatch.delattr(lz4tpu_torch, "decompress_blocks_to_device")
    with pytest.raises(harness.BenchError):
        _entry()
