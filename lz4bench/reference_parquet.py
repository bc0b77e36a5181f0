"""The plain reference of the ``parquet-lz4raw`` configuration: Parquet
pages compressed with the codec LZ4_RAW, read in Python and numpy from
the Parquet format's own documents (``Compression.md``: LZ4_RAW is the
LZ4 block format, one block a page, no frame; ``Encodings.md``: PLAIN,
RLE_DICTIONARY and the RLE/bit-packed hybrid; ``README.md``: data page
v1, its definition levels behind a 4-byte length).  It imports nothing
of the program and takes nothing the program made.

A request is a row group's pages, each one raw LZ4 block laid end to
end, with the table of sizes a reader takes from the page headers:
:func:`decode_pages` decodes each block with :mod:`lz4bench.reference`'s
``decode_block`` (no match may reach before its own block) and holds it
to its stated size.  :func:`column_values` reads a column chunk's
decoded pages back into its values, so that the benchmark's pages can be
held against the rows they were written from.
"""

from __future__ import annotations

import struct

import numpy as np

from .reference import FrameError, decode_block


class PageError(ValueError):
    """A page breaks the format, or its stated size."""


def decode_pages(data: bytes, comp_sizes, out_sizes) -> list:
    """Each raw LZ4 block of ``data`` (``comp_sizes`` bytes each, end to
    end), decoded: a list of ``bytes``, each exactly its ``out_sizes``
    entry long."""
    comp = [int(c) for c in comp_sizes]
    want = [int(c) for c in out_sizes]
    if len(comp) != len(want):
        raise PageError("the size tables differ in length")
    if sum(comp) > len(data):
        raise PageError("the compressed sizes run past the data")
    pages, pos = [], 0
    for k, (c, w) in enumerate(zip(comp, want)):
        out = bytearray()
        if c:
            try:
                decode_block(bytes(data[pos:pos + c]), out, 0)
            except (FrameError, IndexError) as e:
                raise PageError(f"page {k}: {e}") from e
        if len(out) != w:
            raise PageError(f"page {k} decodes to {len(out)} bytes, its "
                            f"stated size is {w}")
        pages.append(bytes(out))
        pos += c
    return pages


# ---------------------------------------------------------------------------
# encodings
# ---------------------------------------------------------------------------

def _uvarint(buf: bytes, pos: int) -> tuple:
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def hybrid(buf: bytes, pos: int, width: int, n: int) -> tuple:
    """``n`` values of the RLE/bit-packed hybrid at ``width`` bits from
    ``buf[pos:]``: ``(int64 array, position after the last run)``."""
    out = np.empty(n, np.int64)
    got = 0
    vbytes = (width + 7) // 8
    while got < n:
        header, pos = _uvarint(buf, pos)
        if header & 1:                      # bit-packed: groups of 8
            count = (header >> 1) * 8
            raw = np.frombuffer(buf, np.uint8, (header >> 1) * width, pos)
            pos += raw.size
            bits = np.unpackbits(raw, bitorder="little").reshape(-1, width)
            vals = (bits.astype(np.int64) << np.arange(width)).sum(1)
        else:                               # repeated run
            count = header >> 1
            vals = np.full(count, int.from_bytes(buf[pos:pos + vbytes],
                                                 "little"), np.int64)
            pos += vbytes
        take = min(count, n - got)
        out[got:got + take] = vals[:take]
        got += take
    return out, pos


def plain(buf: bytes, pos: int, ptype: str, n: int, type_length: int = 0
          ) -> tuple:
    """``n`` PLAIN values of ``ptype`` from ``buf[pos:]``: ``(values,
    position after them)``; integers as an int64 array (a
    FIXED_LEN_BYTE_ARRAY as its big-endian two's complement), byte
    arrays as a list of ``bytes``."""
    if ptype in ("INT32", "INT64"):
        dt = "<i4" if ptype == "INT32" else "<i8"
        vals = np.frombuffer(buf, dt, n, pos).astype(np.int64)
        return vals, pos + vals.size * np.dtype(dt).itemsize
    if ptype == "FIXED_LEN_BYTE_ARRAY":
        vals = np.array([int.from_bytes(buf[p:p + type_length], "big",
                                        signed=True)
                         for p in range(pos, pos + n * type_length,
                                        type_length)], np.int64)
        return vals, pos + n * type_length
    if ptype == "BYTE_ARRAY":
        vals = []
        for _ in range(n):
            (length,) = struct.unpack_from("<I", buf, pos)
            vals.append(bytes(buf[pos + 4:pos + 4 + length]))
            pos += 4 + length
        return vals, pos
    raise PageError(f"no PLAIN decoding of {ptype} here")


def data_page_v1(body: bytes, ptype: str, n: int, dictionary=None,
                 type_length: int = 0):
    """The values of a v1 data page of ``n`` values of an optional flat
    column (max definition level 1, no repetition levels): every value
    present, PLAIN, or RLE_DICTIONARY indices into ``dictionary``."""
    (n_levels,) = struct.unpack_from("<I", body, 0)
    levels, end = hybrid(body, 4, 1, n)
    if end != 4 + n_levels:
        raise PageError("the definition levels end short of their length")
    if not (levels == 1).all():
        raise PageError("a value is null")
    pos = 4 + n_levels
    if dictionary is None:
        vals, end = plain(body, pos, ptype, n, type_length)
    else:
        width = body[pos]
        idx, end = hybrid(body, pos + 1, width, n)
        if n and int(idx.max()) >= len(dictionary):
            raise PageError("an index past the dictionary")
        vals = ([dictionary[i] for i in idx.tolist()]
                if isinstance(dictionary, list) else dictionary[idx])
    if end != len(body):
        raise PageError(f"the page has {len(body) - end} bytes after its "
                        "values")
    return vals


def column_values(pages: list, ptype: str, type_length: int = 0):
    """A column chunk's values from its decoded pages in file order, each
    ``(kind, n_values, body)``: ``kind`` ``"dictionary"`` (a PLAIN
    dictionary page of ``n_values`` entries), ``"indices"`` (a v1 data
    page of RLE_DICTIONARY indices) or ``"plain"`` (a v1 data page of
    PLAIN values)."""
    dictionary, out = None, []
    for kind, n, body in pages:
        if kind == "dictionary":
            dictionary, end = plain(body, 0, ptype, n, type_length)
            if end != len(body):
                raise PageError("the dictionary page has bytes after its "
                                "values")
            continue
        if kind == "indices" and dictionary is None:
            raise PageError("an index page before its dictionary")
        vals = data_page_v1(body, ptype, n, dictionary if kind == "indices"
                            else None, type_length)
        out.append(vals)
    if not out:
        return [] if ptype == "BYTE_ARRAY" else np.zeros(0, np.int64)
    if ptype == "BYTE_ARRAY":
        return [v for vals in out for v in vals]
    return np.concatenate(out)
