"""The port's byte-parallel resolver (torch ops) against the JAX
package's (XLA), function by function, and ``decompress_device`` /
``decompress(backend=)`` as a whole against ``lz4tpu``.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu.device import decode as jdr
from lz4tpu_torch.device import decode as tdr


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(4096)]
    picks = rng.integers(0, 4096, n // 5 + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _src_text(n: int) -> bytes:
    return b"".join(open(m.__file__, "rb").read()
                    for m in (jpl, lz4tpu.api, jdr))[:n]


def _table(data):
    buf = np.frombuffer(data, np.uint8)
    parsed = lz4tpu.frame.parse_frames(buf, lz4tpu.FOR_ALL)
    return buf, jpl.build_seq_table(buf, parsed, lz4tpu.FOR_ALL, data)


PAYLOADS = {
    "text": lambda: _frag_text(30_000, 1),
    "zeros": lambda: bytes(20_000),
    "p3": lambda: b"abc" * 5000,
    "period7": lambda: bytes(i % 7 for i in range(30_000)),
    "stored": lambda: np.random.default_rng(2).integers(
        0, 256, 9000, dtype=np.uint8).tobytes(),
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_build_sources_and_gather_match_jax(name):
    blob = PAYLOADS[name]()
    data = lz4tpu.compress(blob, block_max_code=4)
    buf, t = _table(data)
    n = t.n_out
    produces = (t.lit_len + t.match_len) > 0
    iters = tdr.doubling_iters(t.out_start.size)
    assert iters == jdr.doubling_iters(t.out_start.size)
    js, jflag = jdr.build_sources(
        jnp.asarray(t.out_start), jnp.asarray(t.lit_len),
        jnp.asarray(t.lit_src), jnp.asarray(t.match_off),
        jnp.asarray(produces), jnp.int32(n), n, iters=iters)
    ts, tflag = tdr.build_sources(
        torch.from_numpy(t.out_start.copy()),
        torch.from_numpy(t.lit_len.copy()),
        torch.from_numpy(t.lit_src.copy()),
        torch.from_numpy(t.match_off.copy()),
        torch.from_numpy(produces), n, n, iters=iters)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert bool(tflag) == bool(jflag) is False
    out = tdr.gather_bytes(torch.from_numpy(buf.copy()), ts)
    assert np.array_equal(out.numpy(),
                          np.asarray(jdr.gather_bytes(jnp.asarray(buf), js)))
    assert out.numpy().tobytes() == blob


def test_padded_tail_and_unproductive_sequences():
    """n_out above n_real (the JAX package's bucket padding) resolves
    the tail to comp[0]; sequences that emit nothing claim no byte."""
    comp = np.frombuffer(b"ABCDEFGH", np.uint8)
    out_start = np.array([0, 4, 4, 10], np.int32)
    lit_len = np.array([4, 0, 2, 0], np.int32)
    lit_src = np.array([0, 0, 4, 0], np.int32)
    match_off = np.array([0, 1, 3, 1], np.int32)    # 0: must not divide
    produces = np.array([True, False, True, False])
    args_j = [jnp.asarray(a) for a in (out_start, lit_len, lit_src,
                                       np.maximum(match_off, 1), produces)]
    args_t = [torch.from_numpy(a.copy()) for a in (
        out_start, lit_len, lit_src, match_off, produces)]
    want = jdr.resolve_sources(jnp.asarray(comp), *args_j, 10, 16)
    got = tdr.resolve_sources(torch.from_numpy(comp.copy()), *args_t, 10, 16)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[:10].tobytes() == b"ABCDEFDEFD"


def test_resolver_continue_doubling_deep_chain(monkeypatch):
    """A provenance chain deeper than 2**UNROLL_ITERS forces the
    continue_doubling re-entry: the flag is checked, not assumed."""
    S = 70_000                      # > 2**16 = one extra round needed
    comp = torch.from_numpy(np.frombuffer(b"Q\x00\x00\x00", np.uint8).copy())
    out_start = torch.arange(S, dtype=torch.int32)
    lit_len = torch.zeros(S, dtype=torch.int32)
    lit_len[0] = 1                  # byte 0 is the only literal
    lit_src = torch.zeros(S, dtype=torch.int32)
    match_off = torch.ones(S, dtype=torch.int32)
    produces = torch.ones(S, dtype=torch.bool)
    calls = []
    real = tdr.continue_doubling

    def spy(src, n_out):
        calls.append(n_out)
        return real(src, n_out)

    monkeypatch.setattr(tdr, "continue_doubling", spy)
    src, flag = tdr.build_sources(out_start, lit_len, lit_src, match_off,
                                  produces, S, S)
    assert bool(flag)               # 16 rounds do not reach depth 70000
    out = tdr.resolve_sources(comp, out_start, lit_len, lit_src, match_off,
                              produces, S, S)
    assert calls == [S]
    assert out.numpy().tobytes() == b"Q" * S


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("engine", ["resolve", "auto"])
def test_decompress_device_matches_jax(name, engine):
    blob = PAYLOADS[name]()
    data = lz4tpu.compress(blob, block_max_code=4, block_checksum=True)
    want = jpl.decompress_device(data, engine=engine,
                                 interpret=engine == "auto")
    got = lz4tpu_torch.decompress_device(data, engine=engine, device="cpu")
    assert got == want == blob


def test_decompress_device_mixed_frames_and_stats():
    parts = [_frag_text(40_000, 3), bytes(600_000), _src_text(60_000),
             PAYLOADS["stored"]()]
    data = b"".join(lz4tpu.compress(p) for p in parts)
    st_j, st_t = jpl.DecodeStats(), tpl.DecodeStats()
    want = jpl.decompress_device(data, interpret=True, stats=st_j)
    got = lz4tpu_torch.decompress_device(data, device="cpu", stats=st_t)
    assert got == want == b"".join(parts)
    for f in ("comp_bytes", "out_bytes", "n_frames", "n_blocks", "n_chains",
              "n_seqs", "engine_chains", "engine_bytes"):
        assert getattr(st_t, f) == getattr(st_j, f), f
    assert set(st_t.engine_chains) == {"sparse", "fused", "dense"}
    assert st_t.device_s > 0 and st_t.plan_s > 0 and st_t.scan_s > 0


def test_resolver_chains_in_the_plan(monkeypatch):
    """Chains over the dense cap go to ``plan.other``: through the
    resolver under decompress_to_device, through the segment decode
    under decompress_device."""
    monkeypatch.setattr(tpl, "_DENSE_MAX_CHAIN_OUT", 1 << 15)
    blob = _src_text(50_000)
    data = lz4tpu.compress(blob)
    st = tpl.DecodeStats()
    assert lz4tpu_torch.decompress_device(data, device="cpu",
                                          stats=st) == blob
    assert st.engine_chains == {"resolve": 1}
    for verify in ("host", "device"):
        out = lz4tpu_torch.decompress_to_device(data, device="cpu",
                                                verify=verify)
        assert out.numpy().tobytes() == blob


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_decompress_backend_matches_jax(backend, monkeypatch):
    blob = _frag_text(70_000, 5)           # compresses to under 64 KiB
    data = lz4tpu.compress(blob)
    want = lz4tpu.decompress(data, backend=backend)
    # on this machine the card is absent: route the port's card to the
    # CPU's plain versions, as the JAX package runs its CPU backend
    monkeypatch.setattr(tpl, "_resolve_device",
                        lambda device: torch.device("cpu"))
    assert lz4tpu_torch.decompress(data, backend=backend) == want == blob


def test_decompress_auto_takes_the_card_from_64_kib(monkeypatch):
    import lz4tpu_torch.api as tapi

    calls = []
    monkeypatch.setattr(tpl, "decompress_device",
                        lambda data, res: calls.append(len(data)) or b"dev")
    big = lz4tpu.compress(np.random.default_rng(3).integers(
        0, 256, 70_000, dtype=np.uint8).tobytes())
    small = lz4tpu.compress(b"abc" * 1000)
    assert len(big) >= 1 << 16 > len(small)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tapi.decompress(big) == b"dev" and calls == [len(big)]
    assert tapi.decompress(small) == b"abc" * 1000
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert len(tapi.decompress(big)) == 70_000 and calls == [len(big)]


def test_device_backend_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = lz4tpu.compress(b"abc" * 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lz4tpu_torch.decompress(data, backend="device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lz4tpu_torch.decompress_device(data)
    with pytest.raises(ValueError, match="unsupported device"):
        lz4tpu_torch.decompress_device(data, device="meta")


def _corruptions():
    blob = _frag_text(30_000, 6)
    data = lz4tpu.compress(blob, block_checksum=True, block_max_code=4)
    flip = bytearray(data)
    flip[200] ^= 0x40
    content = bytearray(lz4tpu.compress(blob))
    content[-1] ^= 0x01
    return {"block_checksum": bytes(flip),
            "content_checksum": bytes(content),
            "truncated": data[:-37],
            "bad_magic": b"\x00\x01\x02\x03" + data[4:]}


@pytest.mark.parametrize("engine", ["auto", "pallas", "resolve"])
@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_decompress_device_error_parity(name, engine):
    data = _corruptions()[name]
    with pytest.raises(lz4tpu.Lz4Error) as ej:
        jpl.decompress_device(data, engine=engine, interpret=True)
    with pytest.raises(lz4tpu_torch.Lz4Error) as et:
        lz4tpu_torch.decompress_device(data, engine=engine, device="cpu")
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_empty_inputs():
    for engine in ("auto", "pallas", "resolve"):
        assert lz4tpu_torch.decompress_device(b"", engine=engine,
                                              device="cpu") == b""
        assert lz4tpu_torch.decompress_device(
            lz4tpu.compress(b""), engine=engine, device="cpu") == b""
