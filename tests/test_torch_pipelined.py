"""The port's pipelined single-chain decode held against lz4tpu's on
the CPU.

``lz4tpu_torch.device.fused.decode_fused_pipelined(device="cpu")`` runs
kernel H1's plain versions chunk by chunk; the JAX package's runs its
Pallas kernel in interpret mode.  Same tables, made from seeds: same
bytes, same padded length, same chunk counters, same FusedOverflow
messages, and the same gates in ``_pipelined_rows``.  Tolerance 0.
"""

import jax
import numpy as np
import pytest

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu import FOR_ALL
from lz4tpu.device import fused as jfu
from lz4tpu_torch import native as tnative
from lz4tpu_torch.device import fused as tfu

pytestmark = pytest.mark.skipif(
    not tnative.available(), reason="native engine unavailable")


def _mono_payload(size=400 * 1024, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(32, 127, 8192, dtype=np.uint8)
    chunks = []
    for _ in range(size // 8192 + 2):
        b = base.copy()
        idx = rng.integers(0, 8192, 60)
        b[idx] = rng.integers(32, 127, 60)
        chunks.append(b.tobytes())
    return b"".join(chunks)[:size]


def _src_text(n: int) -> bytes:
    blob = b"".join(open(m.__file__, "rb").read()
                    for m in (jfu, jpl, lz4tpu.api))
    return blob[:n]


def _table(data, pooled_cols=True):
    """The JAX package's table: its columns are plain numpy and go to
    both packages."""
    buf = np.frombuffer(data, np.uint8)
    parsed = lz4tpu.frame.parse_frames(buf, FOR_ALL)
    return buf, jpl.build_seq_table(buf, parsed, FOR_ALL, data,
                                    pooled_cols=pooled_cols)


def _port_table(data, pooled_cols=True):
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    return buf, tpl.build_seq_table(buf, parsed, lz4tpu_torch.FOR_ALL, data,
                                    pooled_cols=pooled_cols)


def _cols(t):
    return t.lit_len, t.match_len, t.match_off, t.lit_src


def _jax_bytes(arr) -> bytes:
    return np.asarray(jax.device_get(arr)).tobytes()


@pytest.mark.parametrize("size,pipe", [(400 * 1024, 16), (400 * 1024, 64),
                                       (150 * 1024, 64), (37 * 1024, 8)])
def test_range_prep_differential(size, pipe):
    """The port's range preps over consecutive chunks reproduce its
    whole-chain prep arrays (the port's kernels do not read the reload
    flag ``scal[:, 6]``, the one column a chunk start may force)."""
    data = lz4tpu_torch.compress(_mono_payload(size), block_max_code=7)
    buf, t = _port_table(data)
    assert t.pre is not None
    whole = tfu.prep_fused(*_cols(t), buf, pooled=False)
    starts_ext, litpos_ext, lits_flat, _max_off = t.pre
    n_sub = whole.n_sub
    assert n_sub == -(-size // tfu.SUB)
    winq = np.zeros(n_sub, np.int32)
    scal = np.zeros((n_sub, 8), np.int32)
    seqrec = np.zeros((n_sub, 2, 8, tfu.SEQ_MAX // 8), np.int32)
    patch = np.zeros((n_sub, 8, tfu.PATCH_MAX // 8), np.int32)
    cols = [np.ascontiguousarray(a, np.int32) for a in _cols(t)]
    n_out = int(starts_ext[t.lit_len.size])
    tot_rec = tot_pat = max_rec = max_pat = 0
    for i_lo in range(0, n_sub, pipe):
        nr, npat, mr, mp = tnative.prep_fused_pre_range(
            *cols, buf, whole.lits.shape[0], starts_ext, litpos_ext,
            lits_flat, n_out, i_lo, min(i_lo + pipe, n_sub),
            winq, scal, seqrec, patch, None)
        tot_rec += nr
        tot_pat += npat
        max_rec = max(max_rec, mr)
        max_pat = max(max_pat, mp)
    assert np.array_equal(seqrec, whole.seqrec[:n_sub])
    assert np.array_equal(patch, whole.patch[:n_sub])
    assert np.array_equal(winq, whole.winq[:n_sub])
    carried = [0, 1, 2, 3, 4, 5, 7]
    assert np.array_equal(scal[:, carried], whole.scal[:n_sub][:, carried])
    assert (tot_rec, tot_pat) == (whole.n_seq_recs, whole.n_patches)
    assert (max_rec, max_pat) == (whole.max_recs, whole.max_patches)


@pytest.mark.parametrize("size,n_chunks", [(400 * 1024, 4), (150 * 1024, 2)],
                         ids=["400k", "150k-tail-padding"])
def test_pipelined_decode_matches_jax(size, n_chunks):
    payload = _mono_payload(size)
    data = lz4tpu.compress(payload, block_max_code=7)
    buf, t = _table(data)
    assert t.pre is not None
    ctr_t, ctr_j = {}, {}
    flat_t, n_t = tfu.decode_fused_pipelined(
        *_cols(t), buf, t.pre, device="cpu", pipe_subs=64, counters=ctr_t)
    flat_j, n_j = jfu.decode_fused_pipelined(
        *_cols(t), buf, t.pre, interpret=True, pipe_subs=64, counters=ctr_j)
    assert n_t == n_j == len(payload)
    # padded launches: every chunk is pipe_subs substeps
    assert flat_t.shape[0] == int(flat_j.shape[0]) == n_chunks * 64 * tfu.SUB
    assert flat_t.numpy()[:n_t].tobytes() == payload
    assert flat_t.numpy()[:n_t].tobytes() == _jax_bytes(flat_j)[:n_j]
    assert ctr_t["chunks"] == ctr_j["chunks"]
    assert len(ctr_t["chunks"]) == n_chunks and ctr_t["chunks"][0] == (0, 64)
    for k in range(n_chunks):
        assert ctr_t["prep_done_t"][k] <= ctr_t["dispatch_t"][k]
        if k:
            assert ctr_t["dispatch_t"][k - 1] <= ctr_t["prep_done_t"][k]


def test_pipelined_empty_chain():
    z = np.zeros(0, np.int32)
    pre = (np.zeros(2, np.int32), np.zeros(2, np.int32),
           np.zeros(16, np.uint8), 1)
    flat, n = tfu.decode_fused_pipelined(z, z, z, z, np.zeros(0, np.uint8),
                                         pre, device="cpu")
    assert n == 0 and flat.shape == (0,)


def test_overflow_messages_match_jax(monkeypatch):
    # more producing sequences in one substep than the record budget
    S = 2048
    ll = np.ones(S, np.int32)
    z = np.zeros(S, np.int32)
    mo = np.ones(S, np.int32)
    ext = np.minimum(np.arange(S + 2, dtype=np.int32), S)
    pre = (ext, ext.copy(), np.zeros(S + 16, np.uint8), 1)
    buf = np.zeros(S, np.uint8)
    with pytest.raises(jfu.FusedOverflow) as ej:
        jfu.decode_fused_pipelined(ll, z, mo, z, buf, pre, interpret=True)
    with pytest.raises(tfu.FusedOverflow) as et:
        tfu.decode_fused_pipelined(ll, z, mo, z, buf, pre, device="cpu")
    assert str(et.value) == str(ej.value)
    assert "seq records per substep (budget 576)" in str(et.value)
    # the native range prep's own overflow (patch budget on source text)
    data = lz4tpu.compress(_src_text(100_000))
    buf, t = _table(data)
    with pytest.raises(jfu.FusedOverflow) as ej:
        jfu.decode_fused_pipelined(*_cols(t), buf, t.pre, interpret=True)
    with pytest.raises(tfu.FusedOverflow) as et:
        tfu.decode_fused_pipelined(*_cols(t), buf, t.pre, device="cpu")
    assert str(et.value) == str(ej.value)
    # no native engine
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(tfu.FusedOverflow,
                       match="pipelined decode requires the native engine"):
        tfu.decode_fused_pipelined(*_cols(t), buf, t.pre, device="cpu")
    assert tpl._pipelined_rows(buf, t, "cpu", True) is None


def _spy(monkeypatch):
    calls = []
    real = tfu.decode_fused_pipelined

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tfu, "decode_fused_pipelined", spy)
    return calls


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_pipelined_api_opt_in(monkeypatch, how):
    payload = _mono_payload(size=200 * 1024)
    data = lz4tpu.compress(payload, block_max_code=7)
    calls = _spy(monkeypatch)
    # default stays the monolithic launch (opt-in flag off)
    monkeypatch.delenv("LZ4TPU_PIPELINE", raising=False)
    res = lz4tpu_torch.decompress_to_device(data, device="cpu")
    assert res.numpy().tobytes() == payload and not calls
    if how == "argument":
        kw = dict(pipelined=True)
    else:
        kw = {}
        monkeypatch.setenv("LZ4TPU_PIPELINE", "1")
    res = lz4tpu_torch.decompress_to_device(data, device="cpu", **kw)
    assert len(calls) == 1
    want = _jax_bytes(lz4tpu.decompress_to_device(data, interpret=True,
                                                  pipelined=True))
    assert res.numpy().tobytes() == want == payload
    # an explicit False wins over the environment
    lz4tpu_torch.decompress_to_device(data, device="cpu", pipelined=False)
    assert len(calls) == 1


@pytest.mark.parametrize("verify", ["host", "device", "none"])
def test_pipelined_under_every_verify_mode(verify):
    payload = _mono_payload(size=160 * 1024, seed=8)
    data = lz4tpu.compress(payload, block_max_code=7)
    res = lz4tpu_torch.decompress_to_device(data, device="cpu",
                                            verify=verify, pipelined=True)
    assert res.numpy().tobytes() == payload
    bad = bytearray(data)
    bad[-1] ^= 0x01                     # the content checksum
    if verify == "none":
        res = lz4tpu_torch.decompress_to_device(
            bytes(bad), device="cpu", verify=verify, pipelined=True)
        assert res.numpy().tobytes() == payload
        return
    with pytest.raises(lz4tpu_torch.ChecksumError) as et:
        lz4tpu_torch.decompress_to_device(bytes(bad), device="cpu",
                                          verify=verify, pipelined=True)
    with pytest.raises(lz4tpu.errors.ChecksumError) as ej:
        lz4tpu.decompress_to_device(bytes(bad), interpret=True,
                                    verify=verify, pipelined=True)
    assert str(et.value) == str(ej.value)


def test_phase1_equals_scan_tuple_on_single_block():
    data = lz4tpu_torch.compress(_mono_payload(300 * 1024, seed=5),
                                 block_max_code=7)
    buf, t = _port_table(data)
    s_e, l_e, lits_e, mo_e = t.pre
    s_g, l_g, lits_g, mo_g = tnative.prep_phase1(*_cols(t), buf)
    assert np.array_equal(s_g, s_e[:s_g.size])
    assert np.array_equal(l_g, l_e[:l_g.size])
    assert np.array_equal(lits_g, lits_e[:lits_g.size])
    assert mo_g == mo_e


def test_pipelined_multi_block_via_phase1(monkeypatch):
    """Linked 64 KiB blocks: one chain, no scan fast-path tuple; the
    native phase-1 pass reconstructs it."""
    payload = _mono_payload(300 * 1024, seed=6)
    data = lz4tpu.compress(payload, block_max_code=4)
    buf, t = _port_table(data)
    assert t.pre is None and len(t.spans) == 5
    assert len(tpl._chains_of(t)) == 1
    calls = _spy(monkeypatch)
    res = lz4tpu_torch.decompress_to_device(data, device="cpu",
                                            pipelined=True)
    assert len(calls) == 1
    want = _jax_bytes(lz4tpu.decompress_to_device(data, interpret=True,
                                                  pipelined=True))
    assert res.numpy().tobytes() == want == payload


@pytest.mark.parametrize("kind", ["zeros", "few-seqs", "two-chains"])
def test_pipelined_skips_what_it_does_not_fit(kind):
    payload, kw = {
        "zeros": (b"\x00" * 100000, dict(block_max_code=7)),
        "few-seqs": (b"abcdefgh" * 5000, {}),
        "two-chains": (_mono_payload(160 * 1024),
                       dict(block_max_code=4, block_independence=True)),
    }[kind]
    data = lz4tpu.compress(payload, **kw)
    buf, t = _port_table(data)
    assert tpl._pipelined_rows(buf, t, "cpu", True) is None
    bufj, tj = _table(data)
    assert jpl._pipelined_rows(bufj, tj, True, True) is None
    res = lz4tpu_torch.decompress_to_device(data, device="cpu",
                                            pipelined=True)
    assert res.numpy().tobytes() == payload


def test_pipelined_not_asked_for_returns_none(monkeypatch):
    data = lz4tpu.compress(_mono_payload(100 * 1024), block_max_code=7)
    buf, t = _port_table(data)
    monkeypatch.delenv("LZ4TPU_PIPELINE", raising=False)
    assert tpl._pipelined_rows(buf, t, "cpu", None) is None
    assert tpl._pipelined_rows(buf, t, "cpu", False) is None
    assert tpl._pipelined_rows(buf, t, "cpu", True) is not None


def test_patch_overflow_falls_back_to_the_monolithic_plan(monkeypatch):
    """Source text overflows the fused patch budget: the pipelined
    decode declines (FusedOverflow -> None) and the plan's mxu2 engine
    decodes it, as in lz4tpu."""
    payload = _src_text(100_000)
    data = lz4tpu.compress(payload)
    buf, t = _port_table(data)
    calls = _spy(monkeypatch)
    assert tpl._pipelined_rows(buf, t, "cpu", True) is None
    assert len(calls) == 1              # it was tried, and overflowed
    stats = tpl.DecodeStats()
    tpl.plan_decode(buf, tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL), t,
                    stats)
    assert stats.engine_chains == {"dense": 1}
    res = lz4tpu_torch.decompress_to_device(data, device="cpu",
                                            pipelined=True)
    want = _jax_bytes(lz4tpu.decompress_to_device(data, interpret=True,
                                                  pipelined=True))
    assert res.numpy().tobytes() == want == payload


def _mixed_arrays(seed):
    rng = np.random.default_rng(seed)
    ro = np.frombuffer(bytes(rng.integers(0, 256, 77, dtype=np.uint8)),
                       np.uint8)                       # read-only
    return [rng.integers(-2**31, 2**31 - 1, (5, 8), dtype=np.int32),
            ro,
            rng.integers(0, 100, (3, 2, 8, 9), dtype=np.int32)[::1],
            np.zeros((0, 3), np.int32),
            rng.integers(0, 2, 300).astype(bool),
            rng.integers(0, 2**40, 7, dtype=np.int64)]


@pytest.mark.parametrize("seed", [0, 1])
def test_to_device_packed_equals_to_device(seed):
    """One packed staging copy hands back what one copy per array does:
    same values, dtypes and shapes (on the CPU: the same tensors)."""
    import torch

    from lz4tpu_torch.device import to_device, to_device_packed

    arrays = _mixed_arrays(seed)
    packed = to_device_packed(arrays, "cpu")
    assert len(packed) == len(arrays)
    for a, got in zip(arrays, packed):
        want = to_device(a, "cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
        assert np.array_equal(got.numpy(), a)
    assert to_device_packed([], "cpu") == []


def test_prep_pool_is_per_thread():
    """Two threads that prepare at once never share a pooled buffer:
    each thread rotates through a pool of its own."""
    import threading

    got = {}

    def take(name):
        got[name] = [tfu._pool_arrays(64, 4096)[1]
                     for _ in range(2 * tfu._POOL_DEPTH)]

    threads = [threading.Thread(target=take, args=(n,)) for n in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    take("main")
    bases = {n: {a.__array_interface__["data"][0] for a in arrs}
             for n, arrs in got.items()}
    for n in bases:
        assert len(bases[n]) == tfu._POOL_DEPTH          # rotation
    assert not (bases["a"] & bases["b"])
    assert not (bases["main"] & (bases["a"] | bases["b"]))
