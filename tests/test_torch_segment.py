"""The port's segment-copy decode (plain version, on the CPU) against
the JAX package's Pallas segment kernel in interpret mode: chain by
chain through ``decode_chain``, and as a whole through
``decompress_device(engine="pallas")``.  Tolerance 0 (bytes).
"""

import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu.device import pallas_decode as jpk
from lz4tpu_torch import _kernels
from lz4tpu_torch.device import segment_decode as tsg
from lz4tpu_torch.exp import edge

RNG = np.random.default_rng(42)

PAYLOADS = {
    "hello": b"Hello, world. Hello, world. Hello, world.",
    "zeros": b"\x00" * 5000,                                  # offset 1
    "p2": b"ab" * 2500,                                       # offset 2
    "p3": b"abc" * 2000,                                      # offset 3
    "p8": b"abcdefgh" * 300,
    "lowent": bytes(RNG.integers(0, 4, 8000, dtype=np.uint8)),
    "mixed": b"x" + b"ab" * 40 + bytes(range(200)) * 3 + b"ab" * 500,
    "stored": bytes(RNG.integers(0, 256, 3000, dtype=np.uint8)),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("indep", [False, True], ids=["linked", "indep"])
def test_pallas_engine_matches_jax(name, indep):
    payload = PAYLOADS[name]
    frame = lz4tpu.compress(payload, block_max_code=4,
                            block_independence=indep, block_checksum=True)
    want = jpl.decompress_device(frame, engine="pallas", interpret=True)
    got = lz4tpu_torch.decompress_device(frame, engine="pallas",
                                         device="cpu")
    assert got == want == payload


def _chain_args(data):
    """Per chain, the arguments lz4tpu.pipeline._decode_pallas gives
    decode_chain, built from the JAX package's own table."""
    buf = np.frombuffer(data, np.uint8)
    parsed = lz4tpu.frame.parse_frames(buf, lz4tpu.FOR_ALL)
    table = jpl.build_seq_table(buf, parsed, lz4tpu.FOR_ALL, data)
    for chain in jpl._chains_of(table):
        n_loc = chain.out_hi - chain.out_lo
        if n_loc == 0:
            continue
        fr = parsed.frames[chain.frame_id]
        sl = slice(chain.seq_lo, chain.seq_hi)
        yield (buf[fr.start:fr.end],
               (table.out_start[sl] - chain.out_lo).astype(np.int32),
               (table.lit_src[sl] - fr.start).astype(np.int32),
               table.lit_len[sl], table.match_off[sl], table.match_len[sl],
               n_loc)


@pytest.mark.parametrize("name", ["p3", "mixed", "lowent"])
def test_decode_chain_matches_jax_kernel(name):
    data = lz4tpu.compress(PAYLOADS[name] * 3, block_max_code=4,
                           block_independence=True)
    outs = []
    for args in _chain_args(data):
        want = jpk.decode_chain(*args, interpret=True)
        got = tsg.decode_chain(*args, device="cpu")
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        dev = tsg.decode_chain_device(*args, device="cpu")
        assert isinstance(dev, torch.Tensor) and dev.shape == (args[-1],)
        outs.append(got.tobytes())
    assert b"".join(outs) == PAYLOADS[name] * 3


def _hand_chain(off: int, mlen: int):
    """One literal run of ``off`` + 3 bytes, then a match of ``mlen``
    bytes at distance ``off``, then 5 literals (match_off 0: the
    block's last sequence carries none)."""
    lits = (np.arange(off + 3 + 5) * 7 % 251).astype(np.uint8)
    ll0 = off + 3
    dst = np.array([0, ll0 + mlen], np.int32)
    lit_src = np.array([0, ll0], np.int32)
    lit_len = np.array([ll0, 5], np.int32)
    match_off = np.array([off, 0], np.int32)
    match_len = np.array([mlen, 0], np.int32)
    n_out = ll0 + mlen + 5
    head = lits[:ll0]
    want = np.concatenate([
        head, np.resize(head[ll0 - off:], mlen), lits[ll0:]])
    return (lits, dst, lit_src, lit_len, match_off, match_len, n_out), want


@pytest.mark.parametrize("off,mlen", [(1, 300), (2, 301), (3, 1000),
                                      (65535, 65535 + 77), (65535, 40),
                                      (7, 7), (9, 4)])
def test_overlapping_match_offsets(off, mlen):
    """``out[md + i] = out[md - off + (i mod off)]`` for offsets 1, 2, 3
    and 65535 (what the JAX kernel's span-doubling replay produces), and
    a trailing sequence with match_off 0 that must not divide by zero."""
    args, want = _hand_chain(off, mlen)
    got = tsg.decode_chain(*args, device="cpu")
    assert np.array_equal(got, want)
    if off < 1000:          # the interpreted Pallas kernel is slow
        assert np.array_equal(jpk.decode_chain(*args, interpret=True), want)


def test_chains_share_one_launch_table():
    data = lz4tpu.compress(PAYLOADS["mixed"] * 200, block_max_code=4,
                           block_independence=True)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, lz4tpu_torch.FOR_ALL, data)
    chains = tpl._chains_of(table)
    assert len(chains) >= 3
    cols, rows = tpl._segment_tables(parsed, table, chains)
    seqs, ch, total, longest = tsg.pack_chains(cols, rows, buf.size, "cpu")
    assert longest == max(c.out_hi - c.out_lo for c in chains) == 65536
    assert seqs.shape == (5, table.out_start.size)
    assert seqs.dtype == torch.int32
    assert ch.shape == (len(chains), 4) and total == table.n_out
    out = tsg.segment_decode(torch.from_numpy(buf.copy()), seqs, ch, total)
    assert out.numpy().tobytes() == PAYLOADS["mixed"] * 200


@pytest.mark.parametrize("field,value", [
    ("dst", 10**6), ("lit_src", 10**6), ("lit_len", -1), ("match_len", -2),
    ("match_off", 10**5)])
def test_out_of_range_tables_are_refused(field, value):
    args, _want = _hand_chain(5, 20)
    comp, cols, n_out = args[0], list(args[1:6]), args[6]
    k = ["dst", "lit_src", "lit_len", "match_off", "match_len"].index(field)
    cols[k] = cols[k].copy()
    cols[k][0] = value
    with pytest.raises(ValueError, match="out of range"):
        tsg.decode_chain(comp, *cols, n_out, device="cpu")


def test_cpu_wrapper_launches_nothing():
    before = dict(_kernels.LAUNCHES)
    args, want = _hand_chain(3, 50)
    assert np.array_equal(tsg.decode_chain(*args, device="cpu"), want)
    assert _kernels.LAUNCHES == before


def test_covers_tells_a_full_table_from_one_with_gaps():
    """An LZ4 sequence table writes every output byte, so its output
    needs no clearing; a table with a hole, a short last chain or a
    chain off its place does, and the hole then reads 0."""
    data = lz4tpu.compress(PAYLOADS["mixed"] * 200, block_max_code=4,
                           block_independence=True)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, lz4tpu_torch.FOR_ALL, data)
    cols, rows = tpl._segment_tables(parsed, table, tpl._chains_of(table))
    assert tsg.covers(cols, rows)
    assert tsg.covers(cols[::-1], rows[::-1])
    n_seqs, cbase, obase, n_loc = rows[-1]
    assert not tsg.covers(cols, rows[:-1] + [(n_seqs, cbase, obase,
                                              n_loc + 1)])
    assert not tsg.covers(cols, rows[:-1] + [(n_seqs, cbase, obase + 1,
                                              n_loc)])
    assert not tsg.covers(cols[1:], rows[1:])
    holed = [c.copy() for c in cols[0]]
    holed[0][1:] += 1           # every later sequence one byte on
    assert not tsg.covers([holed], [rows[0]])
    args, want = _hand_chain(3, 50)
    comp, hand, n_out = args[0], list(args[1:6]), args[6]
    assert tsg.covers([hand], [(hand[0].size, 0, 0, n_out)])
    got = tsg.decode_chain(comp, *hand, n_out + 5, device="cpu")
    assert np.array_equal(got[:n_out], want) and not got[n_out:].any()


def test_pallas_engine_verifies_checksums_like_jax():
    frame = bytearray(lz4tpu.compress(PAYLOADS["mixed"] * 20,
                                      block_checksum=True))
    frame[30] ^= 0x08
    with pytest.raises(lz4tpu.Lz4Error) as ej:
        jpl.decompress_device(bytes(frame), engine="pallas", interpret=True)
    with pytest.raises(lz4tpu_torch.Lz4Error) as et:
        lz4tpu_torch.decompress_device(bytes(frame), engine="pallas",
                                       device="cpu")
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# tables at the edges of the kernel's design (tiles, ring, largest offset)
# ---------------------------------------------------------------------------

def _edge_properties(name, cols, n_out):
    """What each hand-made case must contain to be worth its name."""
    dst, _src, ll, off, ml = (np.asarray(c, np.int64) for c in cols)
    md, end = dst + ll, dst + ll + ml
    has = ml > 0
    crosses = has & (md // edge.TILE != (end - 1) // edge.TILE)
    src_lo, src_hi = md - off, md - off + np.minimum(ml, off)
    back_over_edge = has & (src_lo // edge.TILE != (src_hi - 1) // edge.TILE)
    if name == "ring_far":
        assert n_out > edge.RING_MAX
        assert (has & (off == 65_535) & (md > edge.RING_MAX)).sum() >= 10
        assert crosses.any() and back_over_edge.any()
        assert (ml > 2 * edge.TILE).any()
    elif name == "gaps":
        gap_lo, gap_hi = end[:-1], dst[1:]
        gaps = gap_hi > gap_lo
        assert gaps.sum() > 100
        assert (gaps & (gap_lo // edge.TILE != (gap_hi - 1) // edge.TILE)).any()
        assert n_out > end[-1] and not tsg.covers([cols], [(dst.size, 0, 0,
                                                            n_out)])
    elif name.startswith("overlap"):
        k = int(name[-1])
        assert (has & (off == k) & (ml > 2 * edge.TILE) & crosses
                & (md % edge.TILE == edge.TILE - 10)).any()
    elif name == "off_far":
        assert (has & (off > 65_535)).sum() > 100
        assert (has & (off > edge.RING_MAX)).sum() > 100
        assert (ll > 10 * edge.TILE).any()


@pytest.mark.parametrize("name", sorted(edge.SEGMENT_CASES))
def test_edge_tables_decode_as_their_reference(name):
    """A chain longer than any ring with offset 65,535 and sources back
    across a tile edge; gaps across tile edges; overlapping matches of
    offset 1, 2, 3 across tile edges; offsets above 65,535: the plain
    version decodes each as the numpy reference does."""
    comp, cols, n_out, want = edge.segment_case(name)
    _edge_properties(name, cols, n_out)
    got = tsg.decode_chain(comp, *cols, n_out, device="cpu")
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["overlap1", "overlap2", "overlap3"])
def test_edge_overlaps_match_jax_kernel(name):
    comp, cols, n_out, want = edge.segment_case(name)
    assert np.array_equal(
        jpk.decode_chain(comp, *cols, n_out, interpret=True), want)


@pytest.mark.parametrize("name", ["ring_far", "off_far"])
def test_edge_tables_match_jax_kernel(name):
    """The JAX package's segment kernel (interpret mode) decodes the
    chain beyond the port's ring, offset 65,535 and offsets above it as
    the port's plain version does: it holds the whole chain on the chip
    and admits any ``match_off <= md``."""
    comp, cols, n_out, _want = edge.segment_case(name)
    got = tsg.decode_chain(comp, *cols, n_out, device="cpu")
    assert np.array_equal(
        jpk.decode_chain(comp, *cols, n_out, interpret=True), got)


def test_edge_gaps_where_jax_kernel_defines_them():
    """The JAX package's kernel writes only what a sequence writes: a
    gap keeps whatever its output buffer held, and so does every match
    byte copied from one.  The port defines those bytes (a gap is 0).
    On every byte the table defines without reading a gap the two
    agree; on the rest the port equals the numpy reference."""
    comp, cols, n_out, want = edge.segment_case("gaps")
    # ref_segment on flags: which bytes descend from literals alone
    defined = np.zeros(n_out, bool)
    for d, _ls, ll, off, ml in zip(*(c.tolist() for c in cols)):
        defined[d:d + ll] = True
        if ml:
            md = d + ll
            defined[md:md + ml] = np.resize(defined[md - max(off, 1):md], ml)
    match_bytes = int(np.asarray(cols[4], np.int64).sum())
    assert 1000 < defined.sum() < n_out - 1000
    assert defined.sum() > int(np.asarray(cols[2], np.int64).sum()) + 1000
    assert match_bytes > 1000
    got = tsg.decode_chain(comp, *cols, n_out, device="cpu")
    assert np.array_equal(got, want)
    jax_out = jpk.decode_chain(comp, *cols, n_out, interpret=True)
    assert np.array_equal(jax_out[defined], got[defined])


def test_match_off_above_65535_in_decode_chain():
    """The table format admits a match offset beyond LZ4's 65,535 (any
    ``match_off <= md``); one past the destination start is refused."""
    lits = (np.arange(70_000) * 13 % 251).astype(np.uint8)
    cols = [np.array(c, np.int32) for c in
            ([0, 70_040], [0, 70_000 - 6], [70_000, 6], [69_999, 0],
             [40, 0])]
    got = tsg.decode_chain(lits, *cols, 70_046, device="cpu")
    assert np.array_equal(got[70_000:70_040], lits[1:41])
    assert np.array_equal(got, edge.ref_segment(lits, cols, 70_046))
    assert np.array_equal(
        jpk.decode_chain(lits, *cols, 70_046, interpret=True), got)
    cols[3] = np.array([70_001, 0], np.int32)
    with pytest.raises(ValueError, match="out of range"):
        tsg.decode_chain(lits, *cols, 70_046, device="cpu")


@pytest.mark.parametrize("what", ["backwards", "overlapping"])
def test_tables_out_of_output_order_are_refused(what):
    """The kernel builds the output tile by tile, so ``pack_chains``
    admits only sequences in output order without overlap (gaps are
    fine); the CPU path refuses the same tables.  The JAX package's
    kernel admits them (it walks the table in any order, a later
    sequence writing over an earlier one): here the port is the
    narrower of the two, and no LZ4 table is out of order."""
    args, want = _hand_chain(5, 20)
    comp, cols, n_out = args[0], [c.copy() for c in args[1:6]], args[6]
    if what == "backwards":
        cols = [c[::-1].copy() for c in cols]
    else:
        cols[0][1] -= 1
    with pytest.raises(ValueError, match="output order"):
        tsg.decode_chain(comp, *cols, n_out, device="cpu")
    in_turn = edge.ref_segment(comp, cols, n_out)
    assert np.array_equal(in_turn, want) == (what == "backwards")
    assert np.array_equal(
        jpk.decode_chain(comp, *cols, n_out, interpret=True), in_turn)


@pytest.mark.parametrize("max_chain,want", [
    (None, 1 << 17), (0, 1 << 16), (1 << 15, 1 << 16), ((1 << 15) + 1, 1 << 16),
    (1 << 16, 1 << 16), ((1 << 16) + 1, 1 << 17), (1 << 30, 1 << 17)])
def test_ring_is_sized_by_the_longest_chain(max_chain, want):
    """Many 64 KiB chains take a 64 KiB ring each and share an SM; a
    long or unknown chain takes the largest."""
    assert tsg.ring_bytes_for(max_chain) == want


@pytest.mark.parametrize("names,ring", [
    (("overlap1", "gaps"), 1 << 16), (("gaps", "ring_far"), 1 << 17),
    (("off_far",), 1 << 17)])
def test_pack_chains_hands_on_the_longest_chain(names, ring):
    """``pack_chains`` reads the longest chain off the rows it checks,
    so a launch that holds one chain above 64 KiB never gets the small
    ring, wherever that chain stands among short ones."""
    cases = [edge.segment_case(n) for n in names]
    cols = [c[1] for c in cases]
    rows, cbase, obase = [], 0, 0
    for comp, cl, n_out, _want in cases:
        rows.append((cl[0].size, cbase, obase, n_out))
        cbase += comp.size
        obase += n_out
    for order in (slice(None), slice(None, None, -1)):
        _s, _c, total, longest = tsg.pack_chains(cols[order], rows[order],
                                                 cbase, "cpu")
        assert total == obase
        assert longest == max(c[2] for c in cases)
        assert tsg.ring_bytes_for(longest) == ring
