"""lz4tpu_torch.dist held against lz4tpu.dist on the CPU.

The port's meshes here are one CPU device listed 1, 2, 4 or 8 times
(``make_mesh(n, "cpu")``), the counterpart of the JAX package's virtual
CPU devices (``lz4tpu.dist.make_mesh(n)``, tests/conftest.py).  The same
seeded inputs go through both: work units, the chain balance, the span
assignment, the tier each input takes, the span-sharded resolver (its
full-depth retry included), the bytes and exceptions of
``decompress_sharded``, and the device-resident segments.  Tolerance 0:
bytes and integers.  Two processes joined by gloo decode as one process
does.

Every input stays at or below 256 KiB: above it ``lz4tpu`` sends inputs
to its resolver on the CPU platform only (its kernels run interpreted
there), a gate the port does not carry.
"""

import functools
import os
import pathlib
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.dist as jd
import lz4tpu.pipeline as jpl
from lz4tpu import FOR_ALL

import lz4tpu_torch
import lz4tpu_torch.dist as td
import lz4tpu_torch.pipeline as tpl

REPO = pathlib.Path(__file__).resolve().parent.parent

# the corpora, shared with the two-process workers below (exec'd there)
CORPORA_SRC = r'''
import numpy as np
import lz4tpu_torch


def frag_text(n, seed):
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    mean = np.mean([len(f) for f in frags])
    picks = rng.integers(0, 8192, int(n / mean * 1.1) + 16)
    return b"".join(frags[i] for i in picks)[:n]


def rand(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def src_text(n):
    import lz4tpu_torch.pipeline, lz4tpu_torch.api, lz4tpu_torch.stream
    blob = b"".join(open(m.__file__, "rb").read() for m in (
        lz4tpu_torch.pipeline, lz4tpu_torch.api, lz4tpu_torch.stream))
    return blob[:n]


def corpora():
    c = lz4tpu_torch.compress
    mixed = [bytes(50_000), frag_text(60_000, 1), rand(30_000, 2),
             src_text(40_000)]
    mono = frag_text(262_144, 3)
    period = (b"abcdefghij" * 26 + b"X") * 900
    return {
        "mixed": (b"".join(c(p) for p in mixed), b"".join(mixed)),
        "mono": (c(mono), mono),
        "zeros": (c(bytes(200_000)), bytes(200_000)),
        "period": (c(period, block_max_code=4), period),
        "text": (c(src_text(120_000)), src_text(120_000)),
        "zeros-indep": (c(bytes(250_000), block_max_code=4,
                          block_independence=True), bytes(250_000)),
    }
'''
_ns: dict = {}
exec(CORPORA_SRC, _ns)
frag_text, rand, src_text, corpora = (_ns[k] for k in (
    "frag_text", "rand", "src_text", "corpora"))
CORPORA = corpora()
MESHES = (1, 2, 4, 8)


def _table(data):
    buf = np.frombuffer(data, np.uint8)
    parsed = jpl.parse_frames(buf, FOR_ALL)
    return buf, jpl.build_seq_table(buf, parsed, FOR_ALL, data)


def _mono_fused_frame(seed=11, size=220 * 1024):
    """One fused-class chain of 64 KiB blocks (tests/test_spans.py's
    recipe): 8 KiB of text repeated with 60 changes a copy."""
    rng = np.random.default_rng(seed)
    base = rng.integers(32, 127, 8192, dtype=np.uint8)
    chunks = []
    for _ in range(size // 8192 + 2):
        b = base.copy()
        idx = rng.integers(0, 8192, 60)
        b[idx] = rng.integers(32, 127, 60)
        chunks.append(b.tobytes())
    payload = b"".join(chunks)[:size]
    return payload, lz4tpu.compress(payload, block_max_code=4)


def _same_units(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.out_lo, g.out_hi) == (w.out_lo, w.out_hi)
        assert isinstance(g, td.SpanUnit) == isinstance(w, jd.SpanUnit)
        if isinstance(g, td.SpanUnit):
            assert g.b_lo == w.b_lo
            assert (g.ring is None) == (w.ring is None)
            if g.ring is not None:
                assert np.array_equal(g.ring, w.ring)
            for k in ("seqrec", "lits", "winq", "scal", "patch"):
                assert np.array_equal(getattr(g.prep, k),
                                      np.asarray(getattr(w.prep, k))), k
            assert g.prep.out_spans == w.prep.out_spans
        else:
            for k in ("frame_id", "seq_lo", "seq_hi", "independent"):
                assert getattr(g, k) == getattr(w, k), k


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_make_mesh_lists_a_device_as_often_as_asked(monkeypatch):
    mesh = td.make_mesh(8, "cpu")
    assert mesh.size == 8
    assert all(e.device == torch.device("cpu") and e.stream is None
               and e.process_index == 0 for e in mesh.entries)
    assert td.make_mesh(device="cpu").size == 1
    assert td.Mesh(["cpu", torch.device("cpu")]).size == 2
    with pytest.raises(ValueError, match="at least one device"):
        td.Mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (td.make_mesh, lambda: td.make_mesh(4, "cuda:0"),
                 lambda: td.Mesh(["cuda:0"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_initialize_multihost_forwards_its_arguments(monkeypatch):
    import torch.distributed as tdist

    calls = []
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    td.initialize_multihost("10.0.0.1:1234", 2, 1, device="cpu")
    td.initialize_multihost(device="cuda")
    assert calls == [
        ("gloo", {"init_method": "tcp://10.0.0.1:1234", "world_size": 2,
                  "rank": 1}),
        ("nccl", {"init_method": "env://"})]


# ---------------------------------------------------------------------------
# work units, balance, assignment, tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_work_units_match_jax(n):
    for min_subs in (None, 8):
        for payload, frame in (_mono_fused_frame(),
                               _mono_fused_frame(5, 400 * 1024)):
            buf, table = _table(frame)
            got, split_t = td._work_units(table, buf, n, min_subs=min_subs)
            want, split_j = jd._work_units(table, buf, n, min_subs=min_subs)
            assert split_t == split_j
            _same_units(got, want)
            pos = 0
            for u in got:
                assert u.out_lo == pos
                pos = u.out_hi
            assert pos == table.n_out == len(payload)


def test_work_units_fallbacks_match_jax():
    rng = np.random.default_rng(7)
    words = [rng.integers(97, 123, rng.integers(3, 9),
                          dtype=np.uint8).tobytes() for _ in range(300)]
    dense = b" ".join(words[rng.integers(0, 300)]
                      for _ in range(40000))[:200 * 1024]
    _p, small = _mono_fused_frame(seed=5, size=64 * 1024)
    for frame in (lz4tpu.compress(bytes(300 << 10), block_max_code=4),
                  lz4tpu.compress(dense, block_max_code=4), small * 8,
                  lz4tpu.compress(b"")):
        buf, table = _table(frame)
        for n in (1, 8):
            got, split_t = td._work_units(table, buf, n, min_subs=8)
            want, split_j = jd._work_units(table, buf, n, min_subs=8)
            assert not split_t and not split_j
            _same_units(got, want)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_span_split_possible_and_tier_match_jax(name):
    buf, table = _table(CORPORA[name][0])
    chains = jpl._chains_of(table)
    for n in MESHES:
        for min_subs in (None, 8):
            assert (td._span_split_possible(table, n, min_subs)
                    == jd._span_split_possible(table, n, min_subs))
        # lz4tpu's choice (dist.py:796) without its CPU-platform gate
        want = ((len(chains) > 1 or jd._span_split_possible(table, n))
                and max(c.out_hi - c.out_lo for c in chains)
                <= jpl._DENSE_MAX_CHAIN_OUT)
        assert td._use_chains(table, n) == want


def test_balance_chains_matches_jax():
    class C:
        def __init__(self, lo, hi):
            self.out_lo, self.out_hi = lo, hi

    rng = np.random.default_rng(3)
    for _ in range(30):
        sizes = rng.integers(1, 1 << 20, int(rng.integers(1, 40)))
        edges = np.concatenate([[0], np.cumsum(sizes)])
        chains = [C(int(a), int(b)) for a, b in zip(edges, edges[1:])]
        for n in (1, 2, 3, 4, 8, 16):
            assert td._balance_chains(chains, n) == jd._balance_chains(
                chains, n)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_span_assignment_matches_jax(n):
    for name in ("mixed", "mono", "zeros-indep"):
        buf, table = _table(CORPORA[name][0])
        got = td.sharded_span_assignment(table, buf, td.make_mesh(n, "cpu"))
        want = jd.sharded_span_assignment(table, buf, jd.make_mesh(n))
        assert got == want
        spans = got[0]
        assert spans[0][0] == 0 and spans[-1][1] == table.n_out
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def test_mesh_devices_interleave_processes():
    """Entries of several processes interleave as lz4tpu's devices do:
    each process's first entry, then each one's second."""
    class E:
        def __init__(self, p, i):
            self.process_index, self.i = p, i

    class M:
        def __init__(self, entries):
            self.entries = entries
            self.size = len(entries)

    mesh = M([E(p, i) for p in range(3) for i in range(2)])
    order = [(e.process_index, e.i) for e in td._mesh_devices(mesh)]
    assert order == [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1)]


# ---------------------------------------------------------------------------
# tier 3: the span-sharded resolver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", MESHES)
def test_decode_sharded_matches_jax(n):
    for name in ("mono", "zeros", "period", "text"):
        data, blob = CORPORA[name]
        buf, table = _table(data)
        got = td.decode_sharded(table, buf, td.make_mesh(n, "cpu"))
        want = jd.decode_sharded(table, buf, jd.make_mesh(n))
        assert got.dtype == np.uint8
        assert got.tobytes() == np.asarray(want).tobytes() == blob, name


def _deep_table(N):
    """Sequence 0 emits "ABCDE"; every later one copies the 5 bytes
    before it: byte i is about i/5 hops deep."""
    out_start = (np.arange(N + 1, dtype=np.int64) * 5).astype(np.int32)
    lit_len = np.zeros(N + 1, np.int32)
    lit_len[0] = 5
    match_len = np.full(N + 1, 5, np.int32)
    match_len[0] = 0
    n_out = 5 * (N + 1)
    kw = dict(out_start=out_start, lit_len=lit_len,
              lit_src=np.zeros(N + 1, np.int32), match_len=match_len,
              match_off=np.full(N + 1, 5, np.int32), n_out=n_out,
              frame_out_start=np.array([0, n_out], np.int64), spans=[])
    return tpl.SeqTable(**kw), jpl.SeqTable(**kw)


@pytest.mark.parametrize("n,N", [(1, 70_000), (2, 140_000)])
def test_decode_sharded_retries_at_full_depth(n, N):
    """A chain deeper than 2**16 hops in one span: the first attempt's
    rounds leave in-span pointers (the flag trips), and the retry at
    full depth gives the bytes, as lz4tpu's does."""
    t_table, j_table = _deep_table(N)
    buf = np.frombuffer(b"ABCDE", np.uint8)
    span = (max(1024, -(-t_table.n_out // n)) + 127) & ~127
    capped = min(16, td._ceil_log2(max(2, N + 1)) + 1)
    assert span // 5 > (1 << capped)
    args = [torch.from_numpy(a) for a in (
        t_table.out_start, t_table.lit_len, t_table.lit_src,
        t_table.match_off, (t_table.lit_len + t_table.match_len) > 0)]
    _src, unresolved = td._local_resolve(*args, t_table.n_out, d=n - 1,
                                         span=span, local_iters=capped)
    assert bool(unresolved)
    got = td.decode_sharded(t_table, buf, td.make_mesh(n, "cpu"))
    want = jd.decode_sharded(j_table, buf, jd.make_mesh(n))
    assert got.tobytes() == np.asarray(want).tobytes() == b"ABCDE" * (N + 1)


def test_local_resolve_rem_truncates_toward_zero():
    """``lax.rem`` is C's remainder: the port takes ``torch.fmod``; the
    match pointer of an overlapping match is where JAX puts it."""
    a = torch.tensor([-7, 7, -1, 0], dtype=torch.int32)
    m = torch.tensor([3, 3, 5, 5], dtype=torch.int32)
    assert torch.fmod(a, m).tolist() == np.asarray(
        jax.lax.rem(np.array([-7, 7, -1, 0], np.int32),
                    np.array([3, 3, 5, 5], np.int32))).tolist()


# ---------------------------------------------------------------------------
# decompress_sharded and the device-resident segments
# ---------------------------------------------------------------------------

def _spy(monkeypatch, mod, seen):
    for fn in ("decode_sharded_chains", "decode_sharded"):
        real = getattr(mod, fn)

        def wrapped(*a, _real=real, _fn=fn, **k):
            seen.append(_fn)
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)


def _tier(data, n):
    buf, table = _table(data)
    if not td._use_chains(table, n):
        return "resolver"
    return "spans" if td._work_units(table, buf, n)[1] else "chains"


@pytest.mark.parametrize("n", MESHES)
def test_decompress_sharded_matches_jax(n, monkeypatch):
    """Bytes and tier of every corpus on meshes of 1, 2, 4 and 8; the
    corpora take every tier."""
    tiers = {name: _tier(CORPORA[name][0], n) for name in CORPORA}
    assert tiers == {"mixed": "chains", "zeros-indep": "chains",
                     "mono": "resolver" if n == 1 else "spans",
                     "zeros": "resolver", "period": "resolver",
                     "text": "resolver"}
    for name in sorted(CORPORA):
        data, blob = CORPORA[name]
        seen_t, seen_j = [], []
        with monkeypatch.context() as m:
            _spy(m, td, seen_t)
            _spy(m, jd, seen_j)
            got = td.decompress_sharded(data, td.make_mesh(n, "cpu"))
            want = jd.decompress_sharded(data, jd.make_mesh(n))
        assert got == want == blob, name
        assert seen_t == seen_j and len(seen_t) == 1, (name, seen_t, seen_j)


@pytest.mark.parametrize("n", [2, 8])
def test_decode_sharded_chains_match_jax(n):
    """Device-resident segments: the units of lz4tpu's, on the mesh's
    device, the bytes at their offsets; and the host-gathered form."""
    for name in ("mixed", "mono", "zeros-indep"):
        data, blob = CORPORA[name]
        buf, table = _table(data)
        mesh = td.make_mesh(n, "cpu")
        segs = td.decode_sharded_chains_to_device(table, buf, mesh)
        want = jd.decode_sharded_chains_to_device(table, buf,
                                                  jd.make_mesh(n),
                                                  interpret=True)
        got_spans = sorted((lo, lo + t.shape[0]) for lo, t in segs)
        assert got_spans == sorted((lo, lo + int(a.shape[0]))
                                   for lo, a in want)
        assert got_spans == td.sharded_span_assignment(table, buf, mesh)[0]
        for lo, t in segs:
            assert t.device == torch.device("cpu") and t.dtype == torch.uint8
            assert t.numpy().tobytes() == blob[lo:lo + t.shape[0]]
        assert td.decode_sharded_chains(table, buf, mesh).tobytes() == blob


def test_span_units_with_a_small_minimum(monkeypatch):
    """_work_units(min_subs=8) splits a 220 KiB chain into one span an
    entry; the decoders run those spans and they decode as lz4tpu's do."""
    payload, frame = _mono_fused_frame()
    buf, table = _table(frame)
    mesh = td.make_mesh(8, "cpu")
    units, split = td._work_units(table, buf, 8, min_subs=8)
    assert split and sum(isinstance(u, td.SpanUnit) for u in units) > 2
    monkeypatch.setattr(td, "_work_units",
                        functools.partial(td._work_units, min_subs=8))
    out = td.decode_sharded_chains(table, buf, mesh)
    assert out.tobytes() == payload
    segs = td.decode_sharded_chains_to_device(table, buf, mesh)
    assert sorted((lo, lo + t.shape[0]) for lo, t in segs) == [
        (u.out_lo, u.out_hi) for u in units]


def _corruptions():
    text = frag_text(120_000, 12)
    block = bytearray(lz4tpu.compress(text, block_checksum=True,
                                      block_max_code=4))
    block[300] ^= 0x20
    content = bytearray(lz4tpu.compress(text))
    content[-1] ^= 0x01
    trunc = lz4tpu.compress(text)[:-300]
    magic = b"\x00\x11\x22\x33" + lz4tpu.compress(text)[4:]
    return {"block checksum": bytes(block),
            "content checksum": bytes(content),
            "truncated": trunc, "bad magic": magic}


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_error_parity(name):
    data = _corruptions()[name]
    with pytest.raises(lz4tpu.Lz4Error) as want:
        jd.decompress_sharded(data, jd.make_mesh(4))
    for n in (1, 4):
        with pytest.raises(lz4tpu_torch.Lz4Error) as got:
            td.decompress_sharded(data, td.make_mesh(n, "cpu"))
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)


def test_empty_and_zero_output():
    mesh = td.make_mesh(4, "cpu")
    assert td.decompress_sharded(b"", mesh) == b""
    assert jd.decompress_sharded(b"", jd.make_mesh(4)) == b""
    frame = lz4tpu.compress(b"")
    assert td.decompress_sharded(frame, mesh) == b""
    assert lz4tpu_torch.decompress_sharded(frame, device="cpu") == b""


def test_capacity_fallback(monkeypatch):
    """BatchCapacityExceeded goes to the streaming host engine."""
    payload = b"capacity fallback payload " * 100

    def boom(*a, **k):
        raise tpl.BatchCapacityExceeded("forced by test")

    monkeypatch.setattr(tpl, "build_seq_table", boom)
    assert td.decompress_sharded(lz4tpu.compress(payload),
                                 td.make_mesh(2, "cpu")) == payload


def test_default_mesh_is_the_card(monkeypatch):
    data, blob = CORPORA["mixed"]
    assert lz4tpu_torch.decompress_sharded(data, device="cpu") == blob
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lz4tpu_torch.decompress_sharded(data)


def test_compress_sharded_encodes():
    got = td.compress_sharded(b"abc" * 100, td.make_mesh(2, "cpu"))
    assert got == jd.compress_sharded(b"abc" * 100, jd.make_mesh(2))
    assert lz4tpu_torch.decompress(got) == b"abc" * 100


# ---------------------------------------------------------------------------
# two processes (gloo)
# ---------------------------------------------------------------------------

_WORKER = CORPORA_SRC + r'''
import sys
import torch
from lz4tpu_torch import FOR_ALL, decompress_host, dist
from lz4tpu_torch import frame, pipeline

port, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
mesh = dist.make_mesh(4, "cpu")
assert mesh.size == 8
assert [e.process_index for e in mesh.entries] == [0] * 4 + [1] * 4
for name, (data, blob) in corpora().items():
    out = dist.decompress_sharded(data, mesh)
    assert out == decompress_host(data) == blob, name
    open(f"{out_dir}/{name}.{rank}", "wb").write(out)
    buf = np.frombuffer(data, np.uint8)
    table = pipeline.build_seq_table(buf, frame.parse_frames(buf, FOR_ALL),
                                     FOR_ALL, data)
    if dist._use_chains(table, mesh.size):
        assign = dist.sharded_span_assignment(table, buf, mesh)
        segs = dist.decode_sharded_chains_to_device(table, buf, mesh)
        got = sorted((lo, lo + t.shape[0]) for lo, t in segs)
        assert got == assign.get(rank, []), (name, got, assign)
        for lo, t in segs:
            assert t.numpy().tobytes() == blob[lo:lo + t.shape[0]], name
torch.distributed.destroy_process_group()
print(f"WORKER{rank}_OK", flush=True)
'''


def _two_processes(tmp_path, worker: str) -> None:
    """Run ``worker`` in two processes joined by gloo (argv: port, rank,
    output directory); both must print their OK line.  A hang fails the
    test."""
    script = tmp_path / "worker.py"
    script.write_text(worker)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(i), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=150)[0].decode() for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the two processes did not finish in 150 s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"WORKER{i}_OK" in out


def test_two_process_decode(tmp_path):
    """Two processes of four CPU entries each (gloo): both return what
    one process returns, every tier included (the ordered merge, the
    tail all-gather, span units across processes), and each holds the
    segments the assignment gives it."""
    _two_processes(tmp_path, _WORKER)
    one = td.make_mesh(8, "cpu")
    for name, (data, blob) in CORPORA.items():
        single = td.decompress_sharded(data, one)
        for rank in (0, 1):
            assert (tmp_path / f"{name}.{rank}").read_bytes() == single, name


# 64 KiB blocks of fragment text, random bytes and zeros: 5 blocks, so the
# eight entries of two processes hold 1 block each and 3 hold padding
_ENCODE_PAYLOAD = r'''
def encode_payload():
    return frag_text(150_000, 21) + rand(100_000, 22) + bytes(70_000)
'''

_ENCODE_WORKER = CORPORA_SRC + _ENCODE_PAYLOAD + r'''
import sys
import torch
from lz4tpu_torch import dist

port, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
mesh = dist.make_mesh(4, "cpu")
assert mesh.size == 8
payload = encode_payload()
for name, kw in (("linked", {}),
                 ("indep", {"block_independence": True,
                            "block_checksum": True})):
    out = dist.compress_sharded(payload, mesh, block_max_code=4, **kw)
    open(f"{out_dir}/{name}.{rank}", "wb").write(out)
assert dist.compress_sharded(b"", mesh) == lz4tpu_torch.compress(
    b"", backend="device", device="cpu")
torch.distributed.destroy_process_group()
print(f"WORKER{rank}_OK", flush=True)
'''


def test_two_process_encode(tmp_path):
    """Two processes of four CPU entries each (gloo) encode as
    lz4tpu.dist.compress_sharded does on eight devices: each computes
    its entries' blocks and one all-gather joins the deltas."""
    _two_processes(tmp_path, _ENCODE_WORKER)
    ns = {}
    exec(CORPORA_SRC + _ENCODE_PAYLOAD, ns)
    payload = ns["encode_payload"]()
    for name, kw in (("linked", {}),
                     ("indep", {"block_independence": True,
                                "block_checksum": True})):
        want = jd.compress_sharded(payload, jd.make_mesh(8),
                                   block_max_code=4, **kw)
        assert want == lz4tpu.compress(payload, backend="device",
                                       block_max_code=4, **kw)
        for rank in (0, 1):
            assert (tmp_path / f"{name}.{rank}").read_bytes() == want, name


# the soak's long-match payload (seed 1190175549): a match that begins
# more than 64 KiB before a span, which tier 3 once resolved past the
# tails the spans exchange (tests/test_torch_soak.py)
LONG_MATCH_SEED = 1190175549

_TIER3_WORKER = f"seed = {LONG_MATCH_SEED}\n" + r'''
import sys
import numpy as np
import torch
from lz4tpu_torch import dist, pipeline
from lz4tpu_torch.api import decompress_host
from lz4tpu_torch.exp import soak

port, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.initialize_multihost(f"127.0.0.1:{port}", 2, rank, device="cpu")
mesh = dist.make_mesh(2, "cpu")
assert mesh.size == 4
assert [e.process_index for e in mesh.entries] == [0, 0, 1, 1]
rnd = soak.draw_round(np.random.default_rng(seed), seed, None)
buf = np.frombuffer(rnd.frame, np.uint8)
table = pipeline.build_seq_table(
    buf, pipeline.parse_frames(buf, rnd.reservation), rnd.reservation,
    rnd.frame)
assert not dist._use_chains(table, mesh.size)          # tier 3
calls = pipeline.HOST_FALLBACKS
out = dist.decompress_sharded(rnd.frame, mesh, rnd.reservation)
assert pipeline.HOST_FALLBACKS == calls, "the host engine decoded it"
assert out == decompress_host(rnd.frame, rnd.reservation)
open(f"{out_dir}/long.{rank}", "wb").write(out)
torch.distributed.destroy_process_group()
print(f"WORKER{rank}_OK", flush=True)
'''


def test_two_process_tier3_long_match(tmp_path):
    """Tier 3 across two processes of two CPU entries each (gloo): the
    spans' tails cross processes in one all-gather.  On the long-match
    payload both processes return the host engine's bytes, as one
    process of four entries does, and neither calls the host engine.
    ``lz4tpu.dist`` returns wrong bytes here (a known fault of the
    reference package), so the host engine is the reference."""
    from lz4tpu_torch.exp import soak

    rnd = soak.draw_round(np.random.default_rng(LONG_MATCH_SEED),
                          LONG_MATCH_SEED, None)
    assert rnd.kind == "period" and len(rnd.expected) == 398447
    _two_processes(tmp_path, _TIER3_WORKER)
    want = lz4tpu_torch.decompress_host(rnd.frame, rnd.reservation)
    assert want == rnd.expected
    assert td.decompress_sharded(rnd.frame, td.make_mesh(4, "cpu"),
                                 rnd.reservation) == want
    for rank in (0, 1):
        assert (tmp_path / f"long.{rank}").read_bytes() == want, rank
