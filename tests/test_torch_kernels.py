"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU with ``nvcc`` (kernels build at first use); every
test here is marked ``cuda`` and skips without one.  On the card:
``python -m pytest tests/test_torch_kernels.py -q``; ``chip_smoke.py``
runs the same comparisons at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu_torch import FOR_ALL, _kernels, native
from lz4tpu_torch.device import fused as tfu
from lz4tpu_torch.device import mxu2 as tmx
from lz4tpu_torch.device import segment_decode as tsg
from lz4tpu_torch.device import sparse_decode as tsp
from lz4tpu_torch.device import xxh32_cuda as txx
from lz4tpu_torch.device.ring import part_segments, segments_tensor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda")


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(8192)]
    return b"".join(frags[i] for i in rng.integers(0, 8192, n // 5 + 16))[:n]


def _src_text(n: int) -> bytes:
    return b"".join(open(m.__file__, "rb").read()
                    for m in (tfu, tpl, lz4tpu_torch.api, tsp, tmx))[:n]


def _table(data):
    buf = np.frombuffer(data, np.uint8)
    t = tpl.build_seq_table(buf, tpl.parse_frames(buf, FOR_ALL), FOR_ALL,
                            data)
    ranges = [(c.seq_lo, c.seq_hi) for c in tpl._chains_of(t)]
    return (t.lit_len, t.match_len, t.match_off, t.lit_src, buf), ranges


def test_block_fill_kernel(cuda):
    vals = torch.tensor([0, 1, 255, 300, -1, 9], dtype=torch.int32)
    n0 = _kernels.LAUNCHES["block_fill"]
    got = tsp.block_fill(vals.to(cuda))
    assert _kernels.LAUNCHES["block_fill"] == n0 + 1
    assert torch.equal(got.cpu(), tsp.block_fill_plain(vals))


@pytest.mark.parametrize("independent", [False, True])
@pytest.mark.parametrize("part_subs", [None, 13])
def test_fused_kernels(cuda, independent, part_subs):
    kw = dict(block_max_code=4, block_independence=True) if independent \
        else {}
    cols, ranges = _table(lz4tpu_torch.compress(_frag_text(600_000, 11), **kw))
    prep = tfu.prep_fused(*cols, chain_ranges=ranges, pooled=False)
    rng = np.random.default_rng(1)
    seed = torch.from_numpy(rng.integers(0, 256, 65536, dtype=np.uint8))
    n = prep.n_sub
    t = {k: torch.from_numpy(np.ascontiguousarray(getattr(prep, k)[:n]))
         for k in ("seqrec", "scal", "patch", "winq")}
    pos_k = tfu.expand(*(t[k].to(cuda) for k in ("seqrec", "scal",
                                                  "patch")))
    pos_p = tfu.expand_plain(t["seqrec"], t["scal"], t["patch"])
    assert torch.equal(pos_k.cpu(), pos_p)
    rows_k, ring_k = tfu.decode_fused_rows(prep, cuda, ring_in=seed.to(cuda),
                                           part_subs=part_subs)
    rows_p, ring_p = tfu.decode_fused_rows(prep, "cpu", ring_in=seed,
                                           part_subs=part_subs)
    torch.cuda.synchronize()
    assert torch.equal(rows_k.cpu(), rows_p)
    assert torch.equal(ring_k.cpu(), ring_p)


@pytest.mark.parametrize("independent", [False, True])
def test_mxu2_kernel(cuda, independent):
    kw = dict(block_max_code=4, block_independence=True) if independent \
        else {}
    cols, ranges = _table(lz4tpu_torch.compress(_src_text(300_000), **kw))
    pack = tmx.pack_dense2(*cols, chain_ranges=ranges)
    segs = part_segments(pack.out_spans, 0, pack.n_sub, False)
    code, scal = torch.from_numpy(pack.code), torch.from_numpy(pack.scal)
    rows_k, ring_k = tmx.route(code.to(cuda), scal.to(cuda),
                               segments_tensor(segs, cuda))
    rows_p, ring_p = tmx.route_plain(code, scal, segments_tensor(segs, "cpu"))
    torch.cuda.synchronize()
    assert torch.equal(rows_k.cpu(), rows_p)
    assert torch.equal(ring_k.cpu(), ring_p)


@pytest.mark.parametrize("kind", ["zeros", "fused", "mxu2"])
def test_decompress_to_device_on_card(cuda, kind):
    blob = {"zeros": bytes(3_000_000), "fused": _frag_text(400_000, 3),
            "mxu2": _src_text(200_000)}[kind]
    counter = {"zeros": "block_fill", "fused": "fused_route",
               "mxu2": "mxu2_route"}[kind]
    n0 = _kernels.LAUNCHES[counter]
    out = lz4tpu_torch.decompress_to_device(lz4tpu_torch.compress(blob))
    assert out.is_cuda
    assert out.cpu().numpy().tobytes() == blob
    assert _kernels.LAUNCHES[counter] > n0


@pytest.mark.parametrize("seed", range(4))
def test_card_equals_plain_on_mixed_frames(cuda, seed):
    """Frames mixing every engine, with random options, decode to the
    same bytes on the card as through the plain versions."""
    rng = np.random.default_rng(900 + seed)
    parts = [bytes(int(rng.integers(1, 2_000_000))),
             _frag_text(int(rng.integers(1, 700_000)), seed),
             _src_text(int(rng.integers(1, 200_000))),
             rng.integers(0, 256, int(rng.integers(1, 300_000)),
                          np.uint8).tobytes()]
    order = rng.permutation(len(parts))
    blob = b"".join(parts[i] for i in order)
    data = lz4tpu_torch.compress(blob, block_max_code=int(rng.integers(4, 8)),
                           block_independence=bool(rng.integers(0, 2)))
    out = lz4tpu_torch.decompress_to_device(data)
    plain = lz4tpu_torch.decompress_to_device(data, device="cpu")
    assert torch.equal(out.cpu(), plain)
    assert plain.numpy().tobytes() == blob


def test_kernel_rejects_cpu_mix(cuda):
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmx.route(torch.zeros((1, 2048), dtype=torch.int32, device=cuda),
                  torch.zeros((1, 1), dtype=torch.int32),
                  torch.zeros((1, 3), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("lo,n", [(0, 16), (1, 4096), (13, 70_001 - 13),
                                  (3, 16 * 1024 + 5), (16, 16 * 2049)])
def test_xxh32_stream_kernel(cuda, lo, n):
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.integers(0, 256, 70_001, dtype=np.uint8))
    seed = txx.seed_state("cpu")
    n0 = _kernels.LAUNCHES["xxh32_stream"]
    got = txx.xxh32_stream(data.to(cuda), lo, n // 16, seed.to(cuda))
    assert _kernels.LAUNCHES["xxh32_stream"] == n0 + 1
    assert torch.equal(got.cpu(),
                       txx.xxh32_stream_plain(data, lo, n // 16, seed))
    # carried state: two launches equal one
    half = (n // 16) // 2
    mid = txx.xxh32_stream(data.to(cuda), lo, half, seed.to(cuda))
    two = txx.xxh32_stream(data.to(cuda), lo + 16 * half, n // 16 - half,
                           mid)
    assert torch.equal(two, got)
    assert (txx.xxh32_of_device_array(data.to(cuda), lo, lo + n)
            == native.native_xxh32(data.numpy()[lo:lo + n]))


def test_xxh32_blocks_kernel(cuda):
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.integers(0, 256, 200_000, dtype=np.uint8))
    offs = [0, 7, 1001, 30_000, 99_999, 199_990, 5]
    lens = [3, 15, 4099, 40_001, 16 * 1024, 10, 0]
    ot, lt_ = torch.tensor(offs), torch.tensor(lens)
    n0 = _kernels.LAUNCHES["xxh32_blocks"]
    got = txx.xxh32_blocks(data.to(cuda), ot.to(cuda), lt_.to(cuda))
    assert _kernels.LAUNCHES["xxh32_blocks"] == n0 + 1
    assert torch.equal(got.cpu(), txx.xxh32_blocks_plain(data, ot, lt_))
    assert (txx.xxh32_blocks_device(data.to(cuda), offs, lens)
            == [native.native_xxh32(data.numpy()[o:o + n])
                for o, n in zip(offs, lens)])


@pytest.mark.parametrize("kind", ["text", "zeros", "p3", "indep", "stored"])
def test_segment_decode_kernel(cuda, kind):
    blob, kw = {
        "text": (_src_text(150_000), {}),
        "zeros": (bytes(300_000) + b"tail", {}),
        "p3": (b"abc" * 30_000 + b"x" + b"ab" * 5000, {}),
        "indep": (_frag_text(400_000, 8),
                  dict(block_max_code=4, block_independence=True)),
        "stored": (np.random.default_rng(2).integers(
            0, 256, 100_000, dtype=np.uint8).tobytes(), {}),
    }[kind]
    data = lz4tpu_torch.compress(blob, **kw)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, FOR_ALL, data)
    chains = [c for c in tpl._chains_of(table) if c.out_hi > c.out_lo]
    cols, rows = tpl._segment_tables(parsed, table, chains)
    comp = torch.from_numpy(buf.copy())
    seqs, ch, total = tsg.pack_chains(cols, rows, buf.size, "cpu")
    n0 = _kernels.LAUNCHES["segment_decode"]
    got = tsg.segment_decode(comp.to(cuda), seqs.to(cuda), ch.to(cuda), total)
    assert _kernels.LAUNCHES["segment_decode"] == n0 + 1
    assert got.cpu().numpy().tobytes() == blob
    if kind != "text":      # the plain loop is slow on many sequences
        assert torch.equal(got.cpu(),
                           tsg.segment_decode_plain(comp, seqs, ch, total))


def test_segment_decode_clears_what_no_sequence_writes(cuda):
    lits = np.arange(40, dtype=np.uint8)
    cols = [np.array(c, np.int32) for c in
            ([0, 30], [0, 8], [8, 4], [3, 0], [12, 0])]
    assert not tsg.covers([cols], [(2, 0, 0, 50)])
    got = tsg.decode_chain_device(lits, *cols, 50, device=cuda).cpu()
    want = tsg.decode_chain_device(lits, *cols, 50, device="cpu")
    assert torch.equal(got, want)
    assert not got[20:30].any() and not got[34:].any() and got[19] != 0


@pytest.mark.parametrize("engine", ["auto", "pallas", "resolve"])
def test_decompress_device_on_card(cuda, engine):
    blob = _frag_text(300_000, 9) + bytes(100_000) + _src_text(100_000)
    data = lz4tpu_torch.compress(blob, block_checksum=True, block_max_code=5)
    assert lz4tpu_torch.decompress_device(data, engine=engine) == blob
    assert lz4tpu_torch.decompress(data, backend="device") == blob


def test_verify_device_on_card(cuda):
    blob = _frag_text(300_000, 10)
    data = lz4tpu_torch.compress(blob, block_checksum=True, block_max_code=4)
    before = dict(_kernels.LAUNCHES)
    out = lz4tpu_torch.decompress_to_device(data, verify="device")
    assert out.cpu().numpy().tobytes() == blob
    assert _kernels.LAUNCHES["xxh32_blocks"] == before["xxh32_blocks"] + 1
    assert _kernels.LAUNCHES["xxh32_stream"] == before["xxh32_stream"] + 1
    for at in (300, len(data) - 1):
        bad = bytearray(data)
        bad[at] ^= 0x10
        with pytest.raises(lz4tpu_torch.ChecksumError) as ed:
            lz4tpu_torch.decompress_to_device(bytes(bad), verify="device")
        with pytest.raises(lz4tpu_torch.ChecksumError) as eh:
            lz4tpu_torch.decompress_host(bytes(bad))
        assert str(ed.value) == str(eh.value)


def test_decode_split_on_card(cuda):
    cols, ranges = _table(lz4tpu_torch.compress(_frag_text(300_000, 12)))
    prep = tfu.prep_fused(*cols, chain_ranges=ranges, pooled=False)
    n = prep.n_sub
    args = [torch.from_numpy(np.ascontiguousarray(getattr(prep, k)))
            for k in ("seqrec", "lits", "winq", "scal", "patch")]
    rows_k, ring_k = tfu.decode_split(*(a.to(cuda) for a in args), n_sub=n)
    rows_p, ring_p = tfu.decode_split(*args, n_sub=n)
    assert torch.equal(rows_k.cpu(), rows_p)
    assert torch.equal(ring_k.cpu(), ring_p)


@pytest.mark.parametrize("variant", ["exact", "prefetch"])
@pytest.mark.parametrize("sub", [2048, 3072, 4096, 6144, 12288])
def test_mxu2_route_ab_kernel(cuda, sub, variant):
    """Kernel H7 against its plain version for every exact substep
    size: 200 KB wrap the ring three times, from a seeded ring."""
    from lz4tpu_torch.exp import ab

    blob = _src_text(200_000)
    code, _scal, n_out = ab.pack_host(lz4tpu_torch.compress(blob), sub)
    ring_in = torch.from_numpy(np.random.default_rng(sub).integers(
        0, 256, 65536, dtype=np.uint8))
    code_t = torch.from_numpy(code)
    n0 = _kernels.LAUNCHES["mxu2_route_ab"]
    rows_k, ring_k = ab.route_variant(code_t.to(cuda), sub,
                                      ring_in.to(cuda), variant)
    assert _kernels.LAUNCHES["mxu2_route_ab"] == n0 + 1
    rows_p, ring_p = ab.route_variant_plain(code_t, sub, ring_in)
    torch.cuda.synchronize()
    assert torch.equal(rows_k.cpu(), rows_p)
    assert torch.equal(ring_k.cpu(), ring_p)
    assert rows_p.numpy()[:n_out].tobytes() == blob


def test_mxu2_route_ab_ablations_launch(cuda):
    """The timing-only variants launch and leave the ring shape alone
    (their bytes are not the decode and are not compared)."""
    from lz4tpu_torch.exp import ab

    code, _scal, _n = ab.pack_host(
        lz4tpu_torch.compress(_src_text(100_000)), 4096)
    code_t = torch.from_numpy(code).to(cuda)
    for variant in ab.VARIANTS:
        rows, ring = ab.route_variant(code_t, 4096, None, variant)
        torch.cuda.synchronize()
        assert rows.shape == (code.size,) and ring.shape == (65536,)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ab.route_variant(code_t, 4096, torch.zeros(65536,
                                                   dtype=torch.uint8))


def test_harness_runs_on_card(cuda):
    from lz4tpu_torch.exp import ab

    blob = _src_text(150_000)
    rows = ab.run(lz4tpu_torch.compress(blob), blob,
                  ("sub2k", "p3sf6k", "noring@12288"), lo=2, hi=6, rounds=3)
    assert [r["sub"] for r in rows] == [2048, 6144, 12288]
    assert all(r["ms"] > 0 for r in rows)


def test_pipelined_on_card(cuda):
    blob = _frag_text(700_000, 21)
    data = lz4tpu_torch.compress(blob)
    before = dict(_kernels.LAUNCHES)
    out = lz4tpu_torch.decompress_to_device(data, pipelined=True)
    assert out.cpu().numpy().tobytes() == blob
    n_chunks = -(-(-(-len(blob) // tfu.SUB)) // tfu.PIPE_SUBS)
    assert _kernels.LAUNCHES["fused_route"] == before["fused_route"] + n_chunks
    assert (_kernels.LAUNCHES["fused_expand"]
            == before["fused_expand"] + n_chunks)


def test_session_on_card(cuda):
    """A session on the card: every engine, the three ways to collect,
    a corrupted frame between good ones."""
    blobs = [_frag_text(400_000, 22), _src_text(200_000),
             bytes(3_000_000),
             np.random.default_rng(3).integers(
                 0, 256, 300_000, dtype=np.uint8).tobytes(), b""]
    datas = [lz4tpu_torch.compress(b) for b in blobs]
    before = dict(_kernels.LAUNCHES)
    with lz4tpu_torch.DecodeSession(max_inflight=len(datas)) as s:
        assert s.device.type == "cuda"
        tickets = [s.submit(d) for d in datas]
        assert [t.result() for t in tickets] == blobs
        tickets = [s.submit(d) for d in datas]
        for t, b in zip(tickets, blobs):
            arr = t.result_on_device()
            assert arr.is_cuda and arr.cpu().numpy().tobytes() == b
        tickets = [s.submit(d) for d in datas]
        for t, b in zip(tickets, blobs):
            arr = t.result_on_device(verify="none")
            assert arr.cpu().numpy().tobytes() == b
            assert t.result() == b
        bad = bytearray(datas[0])
        bad[-1] ^= 0x01
        t_good, t_bad, t_more = (s.submit(datas[1]), s.submit(bytes(bad)),
                                 s.submit(datas[0]))
        with pytest.raises(lz4tpu_torch.ChecksumError) as ed:
            t_bad.result_on_device()
        with pytest.raises(lz4tpu_torch.ChecksumError) as eh:
            lz4tpu_torch.decompress_host(bytes(bad))
        assert str(ed.value) == str(eh.value)
        assert t_good.result() == blobs[1] and t_more.result() == blobs[0]
    for k in ("fused_expand", "fused_route", "mxu2_route", "block_fill",
              "xxh32_stream"):
        assert _kernels.LAUNCHES[k] > before[k], k


def test_to_device_packed_on_card(cuda):
    """The packed staging copy on the card: views of one device buffer
    with the arrays' values, dtypes and shapes, each aligned for the
    kernels' 16-byte vector loads."""
    from lz4tpu_torch.device import to_device_packed

    rng = np.random.default_rng(5)
    arrays = [rng.integers(-2**31, 2**31 - 1, (64, 2, 8, 72), dtype=np.int32),
              rng.integers(0, 1 << 20, (64, 8, 32), dtype=np.int32),
              rng.integers(0, 16, (64, 8), dtype=np.int32),
              rng.integers(0, 9, 64, dtype=np.int32),
              np.array([[0, 64, 1]], np.int32),
              np.zeros((0, 3), np.int32),
              rng.integers(0, 256, 13, dtype=np.uint8)]
    packed = to_device_packed(arrays, "cuda")
    torch.cuda.synchronize()
    for a, t in zip(arrays, packed):
        assert t.is_cuda and t.is_contiguous() and tuple(t.shape) == a.shape
        assert t.data_ptr() % 16 == 0
        assert np.array_equal(t.cpu().numpy(), a)
