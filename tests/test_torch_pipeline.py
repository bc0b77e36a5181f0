"""lz4tpu_torch.decompress_to_device held against lz4tpu on the CPU.

The whole slice (parse, scan, plan, engines, assembly, host verify)
runs with ``device="cpu"``, i.e. every kernel's plain PyTorch version.
Output bytes, the planned engine per chain, exception classes and
messages must equal the JAX package's.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu import FOR_ALL
from lz4tpu.device import fused as jfu


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    picks = rng.integers(0, 8192, n // 5 + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _src_text(n: int) -> bytes:
    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (jfu, jpl, lz4tpu.api))
    return blob[:n]


def _mono_payload(size: int, seed: int = 3) -> bytes:
    """An 8 KiB block of printable bytes repeated with 60 bytes changed
    each time: one fused chain of long matches at offset 8192."""
    rng = np.random.default_rng(seed)
    base = rng.integers(32, 127, 8192, dtype=np.uint8)
    chunks = []
    for _ in range(size // 8192 + 2):
        b = base.copy()
        idx = rng.integers(0, 8192, 60)
        b[idx] = rng.integers(32, 127, 60)
        chunks.append(b.tobytes())
    return b"".join(chunks)[:size]


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _skippable(payload: bytes) -> bytes:
    return struct.pack("<II", 0x184D2A50, len(payload)) + payload


def _port(data, **kw) -> bytes:
    out = lz4tpu_torch.decompress_to_device(data, device="cpu", **kw)
    assert out.dtype == torch.uint8 and out.ndim == 1
    return out.numpy().tobytes()


def _jax(data, **kw) -> bytes:
    return np.asarray(jpl.decompress_to_device(data, **kw)).tobytes()


def _mixed():
    """Frames whose chains take every engine: sparse (zeros, stored),
    fused, mxu2, and an independent-block frame whose fused candidates
    overflow as a group (per-chain isolation)."""
    blocks = b"".join(_frag_text(60 << 10, 30 + k) if k % 2 else
                      _src_text(60 << 10) for k in range(4))
    payloads = [bytes(700_000), _frag_text(150_000, 1), _src_text(90_000),
                _rand(200_000, 2), blocks]
    data = b"".join(
        lz4tpu.compress(p, block_max_code=4, block_independence=True)
        if i == 4 else lz4tpu.compress(p)
        for i, p in enumerate(payloads))
    return data, b"".join(payloads)


SLICE_CASES = {
    "zeros": (lambda: bytes(900_000), {}),
    "stored": (lambda: _rand(150_000, 3), {}),
    "fused": (lambda: _frag_text(160_000, 11), {}),
    "mxu2": (lambda: _src_text(100_000), {}),
    "independent": (lambda: _frag_text(200_000, 4),
                    dict(block_max_code=4, block_independence=True)),
    "checksums": (lambda: _frag_text(150_000, 5),
                  dict(block_checksum=True, content_size=True)),
    "bmc5": (lambda: _src_text(300_000), dict(block_max_code=5)),
    "bmc6": (lambda: _frag_text(120_000, 6), dict(block_max_code=6)),
    "bmc7": (lambda: _frag_text(120_000, 7), dict(block_max_code=7,
                                                   content_checksum=False)),
    "legacy": (lambda: _frag_text(100_000, 8), dict(frame_format="legacy")),
    "mono-400k": (lambda: _mono_payload(400 * 1024),
                  dict(block_max_code=7)),
    "mono-150k": (lambda: _mono_payload(150 * 1024),
                  dict(block_max_code=7)),
}


@pytest.mark.parametrize("name", sorted(SLICE_CASES))
def test_slice_matches_original_and_jax(name):
    make, kw = SLICE_CASES[name]
    blob = make()
    data = lz4tpu.compress(blob, **kw)
    assert _port(data) == blob == _jax(data)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_mixed_payloads_match_jax(seed):
    """Seeded mixes of runs, noise, repeated words and fragment text
    under random frame options: same bytes and same plan as lz4tpu."""
    rng = np.random.default_rng(500 + seed)
    parts = []
    for _ in range(int(rng.integers(2, 6))):
        kind = int(rng.integers(0, 4))
        n = int(rng.integers(1, 60_000))
        if kind == 0:
            parts.append(bytes([int(rng.integers(0, 256))]) * n)
        elif kind == 1:
            parts.append(rng.integers(0, 256, n, np.uint8).tobytes())
        elif kind == 2:
            word = rng.integers(0, 256, int(rng.integers(2, 90)),
                                np.uint8).tobytes()
            parts.append((word * (n // len(word) + 1))[:n])
        else:
            parts.append(_frag_text(n, seed))
    blob = b"".join(parts)
    kw = dict(block_max_code=int(rng.integers(4, 8)),
              block_independence=bool(rng.integers(0, 2)),
              block_checksum=bool(rng.integers(0, 2)),
              content_size=bool(rng.integers(0, 2)))
    data = lz4tpu.compress(blob, **kw)
    assert _port(data) == blob == _jax(data)
    buf = np.frombuffer(data, np.uint8)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    engines = []
    for mod in (jpl, tpl):
        table = jpl.build_seq_table(buf, parsed, FOR_ALL, data,
                                    pooled_cols=True)
        st = jpl.DecodeStats()
        mod.plan_decode(buf, parsed, table, st)
        engines.append(st.engine_chains)
    assert engines[0] == engines[1]


def test_skippable_and_modern_concatenation():
    a, b = _frag_text(70_000, 9), _src_text(50_000)
    data = (_skippable(b"skip me") + lz4tpu.compress(a)
            + _skippable(b"") + lz4tpu.compress(b))
    assert _port(data) == a + b == _jax(data)


def test_mixed_engines_bytes_and_plan_match_jax():
    data, blob = _mixed()
    assert _port(data) == blob == _jax(data)
    buf = np.frombuffer(data, np.uint8)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    stats = {}
    for name, mod in (("jax", jpl), ("port", tpl)):
        table = jpl.build_seq_table(buf, parsed, FOR_ALL, data,
                                    pooled_cols=True)
        st = jpl.DecodeStats()
        mod.plan_decode(buf, parsed, table, st)
        stats[name] = (st.n_chains, st.engine_chains, st.engine_bytes)
    assert stats["port"] == stats["jax"]
    assert set(stats["port"][1]) == {"sparse", "fused", "dense"}


@pytest.mark.parametrize("name", ["fused", "mxu2", "zeros"])
def test_single_chain_plan_matches_jax(name):
    make, kw = SLICE_CASES[name]
    data = lz4tpu.compress(make(), **kw)
    buf = np.frombuffer(data, np.uint8)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    engines = {}
    for label, mod in (("jax", jpl), ("port", tpl)):
        table = jpl.build_seq_table(buf, parsed, FOR_ALL, data,
                                    pooled_cols=True)
        st = jpl.DecodeStats()
        mod.plan_decode(buf, parsed, table, st)
        engines[label] = st.engine_chains
    want = {"fused": "fused", "mxu2": "dense", "zeros": "sparse"}[name]
    assert engines["port"] == engines["jax"] == {want: 1}


def _corruptions():
    blob = _frag_text(120_000, 12)
    data = lz4tpu.compress(blob, block_checksum=True, block_max_code=4)
    flip = bytearray(data)
    flip[200] ^= 0x40                     # under the first block checksum
    content = bytearray(lz4tpu.compress(blob))
    content[-1] ^= 0x01                   # content checksum
    header = bytearray(data)
    header[5] ^= 0x10                     # descriptor: header checksum
    mono = bytearray(lz4tpu.compress(_mono_payload(160 * 1024, seed=8),
                                     block_max_code=7))
    mono[-1] ^= 0x01                      # content checksum
    return {
        "block_checksum": bytes(flip),
        "content_checksum": bytes(content),
        "truncated": data[:-37],
        "header": bytes(header),
        "bad_magic": b"\x00\x01\x02\x03" + data[4:],
        "mono_content_checksum": bytes(mono),
    }


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_error_parity(name):
    data = _corruptions()[name]
    with pytest.raises(lz4tpu.Lz4Error) as ej:
        jpl.decompress_to_device(data)
    with pytest.raises(lz4tpu.Lz4Error) as eh:
        lz4tpu.decompress_host(data)
    with pytest.raises(lz4tpu_torch.Lz4Error) as et:
        lz4tpu_torch.decompress_to_device(data, device="cpu")
    assert (type(et.value).__name__ == type(ej.value).__name__
            == type(eh.value).__name__)
    assert str(et.value) == str(ej.value) == str(eh.value)


def test_reservation_error_parity():
    data = lz4tpu.compress(bytes(300_000), block_max_code=7)
    res = lz4tpu.Reservation.SZ_64_KIB
    with pytest.raises(lz4tpu.Lz4Error) as ej:
        jpl.decompress_to_device(data, res)
    with pytest.raises(lz4tpu_torch.Lz4Error) as et:
        lz4tpu_torch.decompress_to_device(
            data, lz4tpu_torch.Reservation.SZ_64_KIB, device="cpu")
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_out_written_in_place():
    blob = _frag_text(50_000, 13)
    data = lz4tpu.compress(blob)
    out = torch.full((len(blob) + 10,), 7, dtype=torch.uint8)
    res = lz4tpu_torch.decompress_to_device(data, device="cpu", out=out)
    assert res is out
    assert out[:len(blob)].numpy().tobytes() == blob
    assert out[len(blob):].tolist() == [7] * 10


@pytest.mark.parametrize("bad", ["small", "dtype", "ndim"])
def test_out_errors_match_jax(bad):
    blob = _frag_text(20_000, 14)
    data = lz4tpu.compress(blob)
    n = len(blob)
    port_out, jax_out = {
        "small": (torch.zeros(n - 1, dtype=torch.uint8),
                  jnp.zeros(n - 1, jnp.uint8)),
        "dtype": (torch.zeros(n, dtype=torch.int32),
                  jnp.zeros(n, jnp.int32)),
        "ndim": (torch.zeros((1, n), dtype=torch.uint8),
                 jnp.zeros((1, n), jnp.uint8)),
    }[bad]
    with pytest.raises(ValueError) as ej:
        jpl.decompress_to_device(data, out=jax_out)
    with pytest.raises(ValueError) as et:
        lz4tpu_torch.decompress_to_device(data, device="cpu", out=port_out)
    assert str(et.value) == str(ej.value)


def test_empty_inputs():
    assert _port(b"") == b""
    assert _port(lz4tpu.compress(b"")) == b"" == _jax(lz4tpu.compress(b""))


def test_verify_none_skips_checksums():
    data = _corruptions()["content_checksum"]
    blob = _frag_text(120_000, 12)
    assert _port(data, verify="none") == blob


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lz4tpu_torch.decompress_to_device(lz4tpu.compress(b"abc"))


def test_ported_pieces_decode_and_encode():
    """The pieces once left to port work: ``pipelined=`` is accepted,
    the session and the sharded decode decode, and the device encoder
    (``compress(backend=)``, ``dist.compress_sharded``) writes
    lz4tpu's bytes."""
    import lz4tpu.dist

    import lz4tpu_torch.dist

    data = lz4tpu.compress(b"abc" * 100)
    out = lz4tpu_torch.decompress_to_device(data, device="cpu",
                                            pipelined=True)
    assert out.numpy().tobytes() == b"abc" * 100
    with lz4tpu_torch.DecodeSession(device="cpu") as s:
        assert s.submit(data).result() == b"abc" * 100
    assert lz4tpu_torch.decompress_sharded(
        data, device="cpu") == b"abc" * 100
    assert lz4tpu_torch.dist.compress_sharded(
        b"abc" * 100, lz4tpu_torch.dist.make_mesh(device="cpu")) == \
        lz4tpu.dist.compress_sharded(b"abc" * 100)
    for backend in ("device", "device-emit"):
        assert lz4tpu_torch.compress(
            b"abc" * 100, backend=backend, device="cpu") == \
            lz4tpu.compress(b"abc" * 100, backend=backend)
    assert not hasattr(lz4tpu_torch, "compress_device")


def test_resolver_chains_raise(monkeypatch):
    """Chains over the dense cap used to raise NotImplementedError; the
    resolver is ported, so they decode, and a corrupted one raises what
    the JAX package raises."""
    monkeypatch.setattr(tpl, "_DENSE_MAX_CHAIN_OUT", 1 << 16)
    blob = _src_text(100_000)
    data = lz4tpu.compress(blob)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    plan = tpl.plan_decode(buf, parsed, tpl.build_seq_table(
        buf, parsed, lz4tpu_torch.FOR_ALL, data))
    assert len(plan.other) == 1 and not plan.dense_chains
    assert _port(data) == blob
    bad = bytearray(data)
    bad[-1] ^= 0x01
    with pytest.raises(lz4tpu_torch.ChecksumError) as et:
        lz4tpu_torch.decompress_to_device(bytes(bad), device="cpu")
    with pytest.raises(lz4tpu.ChecksumError) as ej:
        jpl.decompress_to_device(bytes(bad))
    assert str(et.value) == str(ej.value)


def test_exception_classes_are_lz4tpus():
    """The port has its own exception classes with lz4tpu's names,
    hierarchy and messages (it imports nothing of lz4tpu)."""
    for name in ("Lz4Error", "ChecksumError", "DataCorruption",
                 "NotSupported", "TooFewHeaderBytes", "TooLittleMemory"):
        ours, theirs = getattr(lz4tpu_torch, name), getattr(lz4tpu, name)
        assert ours is not theirs
        assert ours.__name__ == theirs.__name__
        assert ([c.__name__ for c in ours.__mro__]
                == [c.__name__ for c in theirs.__mro__])


# ---------------------------------------------------------------------------
# plan_decode(chains=, engine=) against lz4tpu's
# ---------------------------------------------------------------------------

def _plan_pair(data, **kw):
    buf = np.frombuffer(data, np.uint8)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    table = jpl.build_seq_table(buf, parsed, FOR_ALL, data)
    chains = kw.pop("pick", lambda cs: None)(jpl._chains_of(table))
    st_t, st_j = tpl.DecodeStats(), jpl.DecodeStats()
    return (tpl.plan_decode(buf, parsed, table, st_t, chains=chains, **kw),
            jpl.plan_decode(buf, parsed, table, st_j, chains=chains, **kw),
            st_t, st_j)


def _chain_key(c):
    return (c.frame_id, c.seq_lo, c.seq_hi, c.out_lo, c.out_hi,
            c.independent)


def _assert_same_plan(pt, pj):
    assert [(_chain_key(c), p.ops, p.n_out) for c, p in pt.sparse] == [
        (_chain_key(c), p.ops, p.n_out) for c, p in pj.sparse]
    for k in ("dense_chains", "fused_chains", "other"):
        assert [_chain_key(c) for c in getattr(pt, k)] == [
            _chain_key(c) for c in getattr(pj, k)], k
    assert (pt.dense_pack is None) == (pj.dense_pack is None)
    if pt.dense_pack is not None:
        # the port's plan defers the codes: they are its host packer's
        assert np.array_equal(pt.dense_pack.packed().code,
                              np.asarray(pj.dense_pack.code))
        assert np.array_equal(pt.dense_pack.scal,
                              np.asarray(pj.dense_pack.scal))
        for k in ("n_sub", "out_spans"):
            assert getattr(pt.dense_pack, k) == getattr(pj.dense_pack, k)
    assert (pt.fused_prep is None) == (pj.fused_prep is None)
    if pt.fused_prep is not None:
        for k in ("seqrec", "lits", "winq", "scal", "patch"):
            assert np.array_equal(getattr(pt.fused_prep, k),
                                  np.asarray(getattr(pj.fused_prep, k))), k
        for k in ("n_sub", "n_patches", "n_seq_recs", "out_spans",
                  "max_off", "max_recs", "max_patches"):
            assert getattr(pt.fused_prep, k) == getattr(pj.fused_prep, k), k


def _indep_mixed():
    """Independent 64 KiB blocks of fragment text and source text, and
    a frame of zeros: fused, dense and sparse chains."""
    blocks = b"".join(_frag_text(64 << 10, 40 + k) if k % 3 else
                      _src_text(64 << 10) for k in range(7))
    return (lz4tpu.compress(blocks, block_max_code=4,
                            block_independence=True)
            + lz4tpu.compress(bytes(300_000)))


@pytest.mark.parametrize("pick", ["odd", "even", "first", "last", "none"])
def test_plan_decode_chain_subset_matches_jax(pick):
    """chains= plans only the given chains, byte for byte as lz4tpu
    does: the same engine per chain, fused prep, mxu2 pack and sparse
    programs."""
    sel = {"odd": lambda cs: cs[1::2], "even": lambda cs: cs[0::2],
           "first": lambda cs: cs[:1], "last": lambda cs: cs[-1:],
           "none": lambda cs: []}[pick]
    pt, pj, st_t, st_j = _plan_pair(_indep_mixed(), pick=sel)
    _assert_same_plan(pt, pj)
    assert (st_t.n_chains, st_t.engine_chains, st_t.engine_bytes) == (
        st_j.n_chains, st_j.engine_chains, st_j.engine_bytes)
    if pick == "odd":
        assert set(st_t.engine_chains) >= {"fused", "dense"}


@pytest.mark.parametrize("engine", ["mxu2", "auto", "something else"])
def test_plan_decode_engine_matches_jax(engine):
    """engine="mxu2" sends fused-class chains to the mxu2 pack; any
    other name plans as "auto" in both packages (neither raises)."""
    for data in (_indep_mixed(), lz4tpu.compress(_frag_text(160_000, 11))):
        pt, pj, st_t, st_j = _plan_pair(data, engine=engine)
        _assert_same_plan(pt, pj)
        assert st_t.engine_chains == st_j.engine_chains
        if engine == "mxu2":
            assert pt.fused_prep is None and "fused" not in st_t.engine_chains
        else:
            assert pt.fused_prep is not None
    data = lz4tpu.compress(_frag_text(160_000, 11))
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, lz4tpu_torch.FOR_ALL, data)
    plan = tpl.plan_decode(buf, parsed, table, engine="mxu2")
    segs = tpl.build_device_segments(buf, table, plan, "cpu")
    assert tpl.assemble_device_segments(segs, table.n_out, "cpu").numpy(
    ).tobytes() == _frag_text(160_000, 11)
