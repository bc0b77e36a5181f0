"""The mxu2 engine's per-byte codes built from the sequence table: the
plain version of kernel H9 (``mxu2.dense_codes_plain``) against the host
packers, the native ``pack_dense2_chain``, numpy ``_pack_chain`` and the
reference's ``lz4tpu.device.mxu2.pack_dense2``, with tolerance 0, on H9's
edges (``exp/edge.DENSE_CASES``) and on lineitem
frames; the deferred ``DensePack2`` that the planner records, decoded on
the CPU to the bytes of a host-packed one.  CPU only (the kernel's own
tests are in ``test_torch_kernels.py``)."""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import lz4tpu_torch as lt
from lz4bench import encoder, harness
from lz4tpu.device import mxu2 as jmx
from lz4tpu_torch import native, pipeline, trace
from lz4tpu_torch.device import mxu2 as mx
from lz4tpu_torch.exp import edge

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "lz4bench/configs/arrow-lz4frame.json")
                    .read_text())
SUB = mx.SUB


def _lineitem():
    """64 KiB of lineitem record batches, one frame a buffer at the
    ``arrow-lz4frame`` configuration's flags; every block chain of their
    sequence table."""
    entry = harness._load_file(harness.HERE / "entries" / "decode_frames.py",
                               "entry")
    raw = harness.corpus("tpch_lineitem").make(
        64 << 10, harness.generator(2**31 + 3, "tpch_lineitem", 0))
    data = b"".join(encoder.compress_frame(b, CONFIG["frame"],
                                           CONFIG["level"], workers=1)
                    for b in entry.split(raw))
    buf = np.frombuffer(data, np.uint8)
    t = pipeline.build_seq_table(
        buf, pipeline.parse_frames(buf, lt.FOR_ALL), lt.FOR_ALL, data)
    ranges = [(c.seq_lo, c.seq_hi) for c in pipeline._chains_of(t)]
    return ((t.out_start, t.lit_len, t.lit_src, t.match_len, t.match_off),
            buf, ranges)


CASES = {**{name: functools.partial(edge.dense_case, name)
            for name in edge.DENSE_CASES},
         "lineitem": _lineitem}


def _native(cols, buf, ranges):
    """The native packer's codes of each chain, or its ValueError."""
    _out_start, ll, ls, ml, mo = cols
    out = []
    for lo, hi in ranges:
        try:
            out.append(native.pack_dense2_chain(
                buf, ll[lo:hi], ls[lo:hi], ml[lo:hi], mo[lo:hi])[0].copy())
        except ValueError as e:
            return e
    return out


def _reference(cols, buf, ranges):
    """The reference's pack of the chains (``lz4tpu``'s packer), or its
    ValueError."""
    _out_start, ll, ls, ml, mo = cols
    try:
        return jmx.pack_dense2(ll, ml, mo, ls, buf, chain_ranges=ranges)
    except ValueError as e:
        return e


def _plain(cols, buf, ranges, part):
    """The plain version's codes of each chain, built ``part`` substeps
    at a time, or its ValueError."""
    pack = mx.defer_dense2(cols[0], cols[1], cols[3], cols[4], cols[2], buf,
                           ranges)
    staged = mx.stage_dense_codes(pack, "cpu")
    try:
        flat = torch.cat([
            mx.dense_codes(*staged, p0, min(part, pack.n_sub - p0))
            for p0 in range(0, pack.n_sub, part)]).reshape(-1).numpy()
    except ValueError as e:
        return e
    assert int(staged[3].item()) == 0
    return [flat[slo * SUB:slo * SUB + n]
            for _c, slo, _shi, n in pack.out_spans], flat, pack


@pytest.mark.parametrize("part", [mx.PART_SUBS, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_the_host_packers(case, part):
    cols, buf, ranges = CASES[case]()
    want = _native(cols, buf, ranges)
    got = _plain(cols, buf, ranges, part)
    ref = _reference(cols, buf, ranges)
    if isinstance(want, ValueError):
        assert case == "before-chain"
        assert isinstance(got, ValueError) and isinstance(ref, ValueError)
        assert str(got) == str(want) == str(ref) == (
            "pack_dense2 failed with status 2")
        return
    chains, flat, pack = got
    assert len(chains) == len(want) == len(ranges)
    for g, w in zip(chains, want):
        assert np.array_equal(g, w)
    # the numpy spec, chain by chain, and the packed layout: zeros past
    # each chain's end, as the host packer leaves them
    _out_start, ll, ls, ml, mo = cols
    for (lo, hi), g in zip(ranges, chains):
        assert np.array_equal(g, mx._pack_chain(ll[lo:hi], ls[lo:hi],
                                                ml[lo:hi], mo[lo:hi],
                                                buf)[0])
    host = pack.packed()
    assert host is not pack and host.n_sub == pack.n_sub
    assert host.out_spans == pack.out_spans
    assert np.array_equal(host.scal, pack.scal)
    assert np.array_equal(flat, host.code.reshape(-1))
    # the reference's layout and codes
    assert (ref.n_sub, ref.out_spans) == (pack.n_sub, pack.out_spans)
    assert np.array_equal(np.asarray(ref.scal), pack.scal)
    assert np.array_equal(flat, np.asarray(ref.code).reshape(-1))
    if case != "lineitem":
        assert pack.n_sub > 1


def test_plain_needs_no_native_engine(monkeypatch):
    cols, buf, ranges = CASES["ring"]()
    with_engine = _plain(cols, buf, ranges, mx.PART_SUBS)[1]
    monkeypatch.setattr(native, "available", lambda: False)
    pack = mx.defer_dense2(cols[0], cols[1], cols[3], cols[4], cols[2], buf,
                           ranges)
    assert np.array_equal(pack.packed().code.reshape(-1), with_engine)


def test_the_plan_defers_the_codes():
    """plan_decode records the dense chains' columns, not their codes,
    with the layout the host packer gives them."""
    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (pipeline, mx, lt.api))[:400_000]
    data = lt.compress(blob)
    buf = np.frombuffer(data, np.uint8)
    parsed = pipeline.parse_frames(buf, lt.FOR_ALL)
    table = pipeline.build_seq_table(buf, parsed, lt.FOR_ALL, data)
    plan = pipeline.plan_decode(buf, parsed, table, engine="mxu2")
    pack = plan.dense_pack
    assert pack.code is None and pack.buf is buf and len(plan.dense_chains)
    ranges = [(c.seq_lo, c.seq_hi) for c in plan.dense_chains]
    host = mx.pack_dense2(table.lit_len, table.match_len, table.match_off,
                          table.lit_src, buf, chain_ranges=ranges)
    assert pack.chain_ranges == ranges
    assert (pack.n_sub, pack.out_spans) == (host.n_sub, host.out_spans)
    assert np.array_equal(pack.scal, host.scal)
    assert np.array_equal(pack.packed().code, host.code)


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("case", ["chains", "lineitem"])
def test_deferred_pack_decodes_as_a_host_packed_one(case, seeded):
    cols, buf, ranges = CASES[case]()
    pack = mx.defer_dense2(cols[0], cols[1], cols[3], cols[4], cols[2], buf,
                           ranges)
    ring = (torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, 65536, dtype=np.uint8)) if seeded else None)
    with trace.recording() as rec:
        got = mx.decode_dense2_rows(pack, "cpu", ring_in=ring, part_subs=2)
    want = mx.decode_dense2_rows(pack.packed(), "cpu", ring_in=ring,
                                 part_subs=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # on the CPU the host packs: no codes built on a card, no span
    assert "decode.dense.device_codes" not in rec.counters
    assert rec.seconds("decode.dense.codes") == 0


def test_deferred_decode_keeps_the_host_packers_fault():
    cols, buf, ranges = CASES["before-chain"]()
    pack = mx.defer_dense2(cols[0], cols[1], cols[3], cols[4], cols[2], buf,
                           ranges)
    with pytest.raises(ValueError, match="pack_dense2 failed with status 2"):
        mx.decode_dense2_rows(pack, "cpu")


def test_dense_decodes_end_to_end_on_the_cpu():
    """A frame whose one chain the planner sends to the mxu2 engine
    decodes to its bytes through the deferred pack."""
    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (pipeline, mx))[:300_000]
    data = lt.compress(blob)
    buf = np.frombuffer(data, np.uint8)
    parsed = pipeline.parse_frames(buf, lt.FOR_ALL)
    table = pipeline.build_seq_table(buf, parsed, lt.FOR_ALL, data)
    plan = pipeline.plan_decode(buf, parsed, table, engine="mxu2")
    segs = pipeline.build_device_segments(buf, table, plan, "cpu")
    got = pipeline.assemble_device_segments(segs, table.n_out, "cpu")
    assert bytes(got.numpy()) == blob


def test_stage_dense2_stages_only_for_codes_built_on_a_card():
    """What a caller stages ahead of the launches (the sharded decode's
    first phase): nothing on the CPU, for host codes, or without a pack;
    the host packer builds those codes as the decode launches."""
    cols, buf, ranges = CASES["chains"]()
    pack = mx.defer_dense2(cols[0], cols[1], cols[3], cols[4], cols[2], buf,
                           ranges)
    assert mx.stage_dense2(pack, "cpu") is None
    assert mx.stage_dense2(pack.packed(), "cpu") is None
    assert mx.stage_dense2(None, "cpu") is None
    faults = []
    rows, ring = mx.decode_dense2_rows(pack, "cpu", faults=faults)
    assert faults == []
    want = mx.decode_dense2_rows(pack.packed(), "cpu")
    assert torch.equal(rows, want[0]) and torch.equal(ring, want[1])
