"""TPC-H ``lineitem`` as the pages of one Parquet row group, before
compression: the page bodies a Parquet writer compresses one raw LZ4
block each under the codec LZ4_RAW.

``make(n, rng)`` returns ``n // ROW_BYTES`` rows (at least one) of
:mod:`tpch_lineitem`'s ``lineitem`` (the same rows, types and
``l_comment`` pool; ``ROW_BYTES`` is that corpus's, so the same ``n``
makes as many rows) in row groups of ``ROW_GROUP_ROWS``, the last one
shorter where the rows do not fill it: each row group's 16 column
chunks in schema order (``COLUMNS``), each chunk's pages in file order,
a dictionary page first where the chunk has one.  Each page body is
prefixed by its length as a little-endian int64 and padded with zeros
to a multiple of 8 bytes, as ``tpch_lineitem`` lays out its buffers,
so the many-frame entry's ``split`` reads the bodies back.  Page
headers are not written: a reader parses them on the host and hands
the decoder a table of page sizes, which :func:`row_group` gives with
each body.

The pages are those of parquet-cpp's ``WriterProperties`` defaults of
apache-arrow 17.0.0, as that release's ``pyarrow.parquet.write_table``
writes them (later releases also cap a data page at 20,000 rows; with
that cap lifted, pyarrow 25.0.0 writes these pages byte for byte,
``lz4bench/tests/test_lz4bench_parquet.py``):

* row groups of at most 1,048,576 rows;
* dictionary encoding first, for every column: the dictionary in the
  order values first appear, a PLAIN dictionary page, data pages of
  RLE_DICTIONARY indices (a byte of bit width, then the RLE/bit-packed
  hybrid at the bit width of the dictionary's size when the page is
  written: ``DictEncoder::bit_width``);
* the fallback: after each write batch of ``WRITE_BATCH`` values, once
  the dictionary's PLAIN bytes reach ``DICT_LIMIT``, the dictionary page
  and the index pages so far stay and the rest of the chunk is PLAIN;
* the page cut: after the write batch that takes the page's encoded
  size, as the encoder estimates it, to ``PAGE_SIZE``: PLAIN its bytes,
  RLE_DICTIONARY ``DictEncoder::EstimatedDataEncodedSize`` (parquet-cpp's
  bound ``1 + RleEncoder::MaxBufferSize + RleEncoder::MinBufferSize``);
* data page v1: the definition levels of a nullable column (no value is
  null, so one RLE run of ones) behind their 4-byte length, then the
  values; no repetition levels (flat schema), no page CRC;
* the hybrid encoder is ``RleEncoder``'s: values taken in groups of 8
  from where the last repeated run ended; a group of 8 equal values
  starts a repeated run that lasts while the value does, other groups
  are bit-packed, at most 63 groups a bit-packed run; a last partial
  group is a repeated run where its values are equal and no bit-packed
  run is open, else it is padded with zeros to 8.

Physical types as pyarrow maps lineitem's Arrow types: keys INT64,
``l_linenumber`` INT32, the decimal128(15,2) columns
FIXED_LEN_BYTE_ARRAY(7) big-endian two's complement, dates INT32, text
BYTE_ARRAY (PLAIN: a 4-byte little-endian length, then the bytes).
"""

import dataclasses
import struct

import numpy as np

from lz4bench import harness

_rows = harness.corpus("tpch_lineitem")

ROW_BYTES = _rows.ROW_BYTES
ROW_GROUP_ROWS = 1 << 20
PAGE_SIZE = 1 << 20          # WriterProperties data_pagesize
DICT_LIMIT = 1 << 20         # dictionary_pagesize_limit
WRITE_BATCH = 1024           # write_batch_size
MAX_LITERAL_GROUPS = 63      # groups of 8 a bit-packed run (RleEncoder)

#: The 16 columns in schema order: (name, physical type, value bytes of a
#: fixed-width type).
COLUMNS = (
    ("l_orderkey", "INT64", 8), ("l_partkey", "INT64", 8),
    ("l_suppkey", "INT64", 8), ("l_linenumber", "INT32", 4),
    ("l_quantity", "FIXED_LEN_BYTE_ARRAY", 7),
    ("l_extendedprice", "FIXED_LEN_BYTE_ARRAY", 7),
    ("l_discount", "FIXED_LEN_BYTE_ARRAY", 7),
    ("l_tax", "FIXED_LEN_BYTE_ARRAY", 7),
    ("l_returnflag", "BYTE_ARRAY", 0), ("l_linestatus", "BYTE_ARRAY", 0),
    ("l_shipdate", "INT32", 4), ("l_commitdate", "INT32", 4),
    ("l_receiptdate", "INT32", 4), ("l_shipinstruct", "BYTE_ARRAY", 0),
    ("l_shipmode", "BYTE_ARRAY", 0), ("l_comment", "BYTE_ARRAY", 0))


@dataclasses.dataclass
class Page:
    """One page as its header would describe it, and its body."""
    column: str
    kind: str            # "dictionary" | "indices" | "plain"
    n_values: int        # dictionary entries, or the data page's values
    body: np.ndarray     # uint8, uncompressed


# ---------------------------------------------------------------------------
# a column's values
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Values:
    """A column's values: fixed-width (``fixed``: each value's PLAIN
    bytes a row) or byte arrays (``flat[start:start + length]`` a row),
    with ``keys``, equal where the values are (None: by content, on
    demand)."""
    fixed: np.ndarray | None = None
    flat: np.ndarray | None = None
    start: np.ndarray | None = None
    length: np.ndarray | None = None
    keys: np.ndarray | None = None

    @property
    def n(self) -> int:
        return (self.fixed if self.fixed is not None else self.length).shape[0]

    def entry_bytes(self) -> np.ndarray:
        """Each row's bytes as a PLAIN dictionary entry."""
        if self.fixed is not None:
            return np.full(self.n, self.fixed.shape[1], np.int64)
        return 4 + self.length.astype(np.int64)

    def content_keys(self, hi: int) -> np.ndarray:
        """Keys of rows ``:hi``, equal where the values are."""
        if self.keys is not None:
            return self.keys[:hi]
        length = self.length[:hi]
        width = int(length.max()) + 1
        cols = np.arange(width - 1)
        idx = np.minimum(self.start[:hi, None] + cols, self.flat.size - 1)
        mat = np.where(cols < length[:, None], self.flat[idx], 0)
        mat = np.concatenate([length[:, None], mat], 1).astype(np.uint8)
        return np.ascontiguousarray(mat).view(f"V{width}").reshape(-1)

    def plain(self, rows: np.ndarray) -> np.ndarray:
        """The PLAIN encoding of ``rows`` (indices), in their order."""
        if self.fixed is not None:
            return self.fixed[rows].reshape(-1)
        length = self.length[rows].astype(np.int64)
        rec = 4 + length
        pos = np.cumsum(rec) - rec
        out = np.empty(int(rec.sum()), np.uint8)
        out[(pos[:, None] + np.arange(4)).reshape(-1)] = (
            length.astype("<u4").view(np.uint8))
        out[np.repeat(pos + 4, length) + _ramp(length)] = _rows._concat(
            self.flat, self.start, self.length, rows)
        return out


def _ramp(length: np.ndarray) -> np.ndarray:
    """0, 1, ... within each run of ``length``, runs end to end."""
    total = int(length.sum())
    return np.arange(total) - np.repeat(np.cumsum(length) - length, length)


def _fixed(values: np.ndarray, width: int, big_endian: bool = False
           ) -> _Values:
    v = values.astype(np.int64)
    if big_endian:            # FIXED_LEN_BYTE_ARRAY: the low bytes, BE
        mat = v.astype(">i8").view(np.uint8).reshape(-1, 8)[:, 8 - width:]
    else:
        mat = v.astype("<i8").view(np.uint8).reshape(-1, 8)[:, :width]
    return _Values(fixed=np.ascontiguousarray(mat), keys=v)


def _categories(picks: np.ndarray, names) -> _Values:
    flat, start, length = _rows._table(names)
    return _Values(flat=flat, start=start[picks], length=length[picks],
                   keys=picks.astype(np.int64))


def columns(t: dict) -> dict:
    """The 16 columns of a ``tpch_lineitem.lineitem`` table, each as its
    Parquet physical values."""
    out = {}
    for name, ptype, width in COLUMNS:
        col = t[name]
        if ptype in ("INT64", "INT32"):
            out[name] = _fixed(col, width)
        elif ptype == "FIXED_LEN_BYTE_ARRAY":
            out[name] = _fixed(col, width, big_endian=True)
        elif name in ("l_returnflag", "l_linestatus"):
            flat = np.ascontiguousarray(col).view(np.uint8)
            out[name] = _Values(flat=flat, start=np.arange(flat.size),
                                length=np.ones(flat.size, np.int64),
                                keys=flat.astype(np.int64))
        elif name == "l_comment":
            start, length = col
            out[name] = _Values(flat=t["pool"], start=start,
                                length=length.astype(np.int64))
        else:
            out[name] = _categories(col, _rows.SHIPINSTRUCT
                                    if name == "l_shipinstruct"
                                    else _rows.SHIPMODE)
    return out


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def bit_width(n_entries: int) -> int:
    """``DictEncoder::bit_width``: the bits of an index into a dictionary
    of ``n_entries``."""
    if n_entries <= 1:
        return n_entries
    return int(n_entries - 1).bit_length()


def hybrid(values: np.ndarray, width: int) -> bytes:
    """The RLE/bit-packed hybrid of ``values`` at ``width`` bits, run by
    run as ``RleEncoder`` writes it (the module's rules)."""
    v = np.asarray(values, np.int64)
    n = v.size
    if n == 0:
        return b""
    # run_end[i]: one past the last of the equal values from i on
    ends = np.append(np.flatnonzero(v[1:] != v[:-1]) + 1, n)
    run_end = np.repeat(ends, np.diff(ends, prepend=0))
    starts8 = np.flatnonzero(run_end - np.arange(n) >= 8)
    by_phase = [starts8[starts8 % 8 == r] for r in range(8)]
    # the stream as stretches of bit-packed groups and repeated runs;
    # each stretch follows a repeated run (or the start), where no
    # bit-packed run is open
    parts, lits = [], []     # ("lit", groups) | ("rep", value, count)
    p = 0
    while p < n:
        cand = by_phase[p % 8]
        i = int(np.searchsorted(cand, p))
        r = int(cand[i]) if i < cand.size else n
        hi = p + (r - p) // 8 * 8
        if r == n and hi < n and ((hi - p) // 8 % MAX_LITERAL_GROUPS
                                  or (v[hi:] != v[hi]).any()):
            hi = n           # the last partial group, padded
        if hi > p:
            lits.append(v[p:hi])
            parts.append(("lit", -(-(hi - p) // 8)))
        if hi < n:
            q = int(run_end[hi]) if r < n else n
            parts.append(("rep", int(v[hi]), q - hi))
            p = q
        else:
            p = n
    vals = np.concatenate(lits) if lits else np.zeros(0, np.int64)
    vals = np.concatenate([vals, np.zeros(-vals.size % 8, np.int64)])
    bits = ((vals[:, None] >> np.arange(width)) & 1).astype(np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    out = bytearray()
    g = 0                    # groups packed so far
    for part in parts:
        if part[0] == "rep":
            out += _varint(part[2] << 1)
            out += part[1].to_bytes((width + 7) // 8, "little")
            continue
        for lo in range(0, part[1], MAX_LITERAL_GROUPS):
            k = min(MAX_LITERAL_GROUPS, part[1] - lo)
            out.append((k << 1) | 1)
            out += packed[(g + lo) * width:(g + lo + k) * width]
        g += part[1]
    return bytes(out)


def def_levels(n: int) -> bytes:
    """A v1 data page's definition levels of ``n`` present values of a
    nullable column: the hybrid's one repeated run of ones at bit width
    1, behind its 4-byte length."""
    run = _varint(n << 1) + b"\x01"
    return struct.pack("<I", len(run)) + run


def dict_estimate(n_buffered: int, width: int) -> int:
    """``DictEncoder::EstimatedDataEncodedSize`` of ``n_buffered`` indices
    at ``width`` bits: 1 + ``RleEncoder::MaxBufferSize`` +
    ``RleEncoder::MinBufferSize``."""
    runs = -(-n_buffered // 8)
    max_buffer = max(runs * (1 + width), runs * (1 + (width + 7) // 8))
    min_buffer = max(1 + (512 * width + 7) // 8, 5 + (width + 7) // 8)
    return 1 + max_buffer + min_buffer


# ---------------------------------------------------------------------------
# a column chunk
# ---------------------------------------------------------------------------

def _first_seen(vals: _Values, hi: int) -> tuple:
    """Of rows ``:hi``: which is the first of its value, and each row's
    index into the dictionary in the order values first appear."""
    keys = vals.content_keys(hi)
    _u, first, inverse = np.unique(keys, return_index=True,
                                   return_inverse=True)
    rank = np.empty(first.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(first.size)
    mask = np.zeros(hi, bool)
    mask[first] = True
    return mask, rank[inverse.reshape(-1)]


def _dictionary_rows(vals: _Values) -> tuple:
    """Where the dictionary falls back: ``(f, mask, index)`` with ``f`` the
    rows encoded by the dictionary (all where it never reaches
    ``DICT_LIMIT``), ``mask`` and ``index`` of :func:`_first_seen` over
    them.  Uniqueness is found on a growing prefix, so a column that
    falls back early costs only its prefix."""
    n = vals.n
    size = vals.entry_bytes()
    hi = min(n, 1 << 16)
    while True:
        mask, index = _first_seen(vals, hi)
        dict_bytes = np.cumsum(np.where(mask, size[:hi], 0))
        batch_end = np.minimum(np.arange(WRITE_BATCH, hi + WRITE_BATCH,
                                         WRITE_BATCH), hi)
        over = np.flatnonzero(dict_bytes[batch_end - 1] >= DICT_LIMIT)
        if over.size:
            f = int(batch_end[over[0]])
            return f, mask[:f], index[:f]
        if hi == n:
            return n, mask, index
        hi = min(n, hi * 4)


def column_chunk(name: str, vals: _Values) -> list:
    """The pages of one column chunk, in file order."""
    n = vals.n
    f, mask, index = _dictionary_rows(vals)
    entries = np.cumsum(mask)
    pages = [Page(name, "dictionary", int(entries[-1]),
                  vals.plain(np.flatnonzero(mask)))]

    def indices_page(lo, hi):
        width = bit_width(int(entries[hi - 1]))
        body = (def_levels(hi - lo) + bytes([width])
                + hybrid(index[lo:hi], width))
        pages.append(Page(name, "indices", hi - lo,
                          np.frombuffer(body, np.uint8)))

    lo = 0
    for end in range(WRITE_BATCH, f + WRITE_BATCH, WRITE_BATCH):
        end = min(end, f)
        if dict_estimate(end - lo, bit_width(int(entries[end - 1]))) \
                >= PAGE_SIZE:
            indices_page(lo, end)
            lo = end
    if lo < f:
        indices_page(lo, f)
    # PLAIN for the rest of the chunk, on the same grid of write batches
    ends = np.concatenate([[0], np.cumsum(vals.entry_bytes())])
    lo = f
    for end in range(f + WRITE_BATCH, n + WRITE_BATCH, WRITE_BATCH):
        end = min(end, n)
        if ends[end] - ends[lo] >= PAGE_SIZE or end == n:
            body = np.concatenate([
                np.frombuffer(def_levels(end - lo), np.uint8),
                vals.plain(np.arange(lo, end))])
            pages.append(Page(name, "plain", end - lo, body))
            lo = end
    return pages


def row_group(t: dict) -> list:
    """Every page of the row group holding the table ``t``'s rows, in
    file order."""
    pages = []
    for name, vals in columns(t).items():
        pages += column_chunk(name, vals)
    return pages


def _slice(t: dict, lo: int, hi: int) -> dict:
    """Rows ``lo:hi`` of the table ``t``."""
    out = {}
    for name, col in t.items():
        if name == "pool":
            out[name] = col
        elif name == "l_comment":
            out[name] = (col[0][lo:hi], col[1][lo:hi])
        else:
            out[name] = col[lo:hi]
    return out


def make(n: int, rng: np.random.Generator) -> np.ndarray:
    rows = max(1, n // ROW_BYTES)
    t = _rows.lineitem(rows, rng, first_order=_rows._stream(rng)
                       * (rows // 4))
    pages = []
    for lo in range(0, rows, ROW_GROUP_ROWS):
        pages += row_group(_slice(t, lo, min(rows, lo + ROW_GROUP_ROWS)))
    return np.concatenate(_rows.body([p.body for p in pages]))
