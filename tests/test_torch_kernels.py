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
from lz4tpu_torch.exp import edge

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
    rows_k, ring_k = tmx._route(code.to(cuda), scal.to(cuda),
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
        tmx._route(torch.zeros((1, 2048), dtype=torch.int32, device=cuda),
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
    seqs, ch, total, longest = tsg.pack_chains(cols, rows, buf.size, "cpu")
    n0 = _kernels.LAUNCHES["segment_decode"]
    got = tsg.segment_decode(comp.to(cuda), seqs.to(cuda), ch.to(cuda), total,
                             max_chain=longest)
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


@pytest.mark.parametrize("variant", ["exact", "prefetch", "serial",
                                     "graph"])
@pytest.mark.parametrize("sub", [2048, 3072, 4096, 6144, 12288])
def test_mxu2_route_ab_kernel(cuda, sub, variant):
    """Kernel H7 against its plain version for every exact variant and
    substep size: 200 KB wrap the ring three times, from a seeded ring."""
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


@pytest.mark.parametrize("sub", [2048, 3072, 4096, 6144, 12288])
def test_mxu2_route_ab_kernel_reads_the_ring(cuda, sub):
    """Every exact variant of H7 on made-up codes whose first substeps
    read the seeded ring (and a zero one), against the plain version;
    the pointer-jumping decode also keeps a short stream's ring_in bytes
    in ring_out, and its graph replays with new pointers each call."""
    from lz4tpu_torch.exp import ab

    ring_in = torch.from_numpy(np.random.default_rng(sub + 1).integers(
        0, 256, 65536, dtype=np.uint8))
    for n_sub in (3, 24):
        code = torch.from_numpy(edge.ab_codes(n_sub, sub))
        for seed in (None, ring_in):
            rows_p, ring_p = ab.route_variant_plain(code, sub, seed)
            for variant in ab.EXACT:
                for _ in range(2):
                    rows_k, ring_k = ab.route_variant(
                        code.to(cuda), sub,
                        None if seed is None else seed.to(cuda), variant)
                    torch.cuda.synchronize()
                    assert torch.equal(rows_k.cpu(), rows_p), variant
                    assert torch.equal(ring_k.cpu(), ring_p), variant


def test_mxu2_route_ab_graph_cache_evicts(cuda):
    """More chain lengths than H7 keeps graphs for at one substep size:
    each graph decode equals the plain version, the first length too
    when its graph has been freed and is built again."""
    from lz4tpu_torch.exp import ab

    for n_sub in (*range(1, 13), 1, 2):
        code = torch.from_numpy(edge.ab_codes(n_sub, 3072, seed=n_sub))
        rows_p, ring_p = ab.route_variant_plain(code, 3072)
        rows_k, ring_k = ab.route_variant(code.to(cuda), 3072, None, "graph")
        torch.cuda.synchronize()
        assert torch.equal(rows_k.cpu(), rows_p), n_sub
        assert torch.equal(ring_k.cpu(), ring_p), n_sub


def test_mxu2_route_ab_live_passes(cuda):
    """The passes one pointer-jumping decode found work in are at most
    passes_for(n_sub), and trimmed to them the decode still launches."""
    from lz4tpu_torch.exp import ab

    code, _scal, n_out = ab.pack_host(
        lz4tpu_torch.compress(_src_text(300_000)), 2048)
    code_t = torch.from_numpy(code).to(cuda)
    live = ab.live_passes(code_t, 2048)
    assert 0 < live <= tmx.passes_for(code.shape[0])
    rows, _ring = ab.route_variant(code_t, 2048, None, "trim", live)
    torch.cuda.synchronize()
    assert rows.shape == (code.size,)


def test_mxu2_route_ab_ablations_launch(cuda):
    """The timing-only variants launch and leave the ring shape alone
    (their bytes are not the decode and are not compared)."""
    from lz4tpu_torch.exp import ab

    code, _scal, _n = ab.pack_host(
        lz4tpu_torch.compress(_src_text(100_000)), 4096)
    code_t = torch.from_numpy(code).to(cuda)
    for variant in ab.VARIANTS:
        passes = 2 if variant in ab.TRIMMED else None
        rows, ring = ab.route_variant(code_t, 4096, None, variant, passes)
        torch.cuda.synchronize()
        assert rows.shape == (code.size,) and ring.shape == (65536,)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ab.route_variant(code_t, 4096, torch.zeros(65536,
                                                   dtype=torch.uint8))


def test_harness_runs_on_card(cuda):
    from lz4tpu_torch.exp import ab

    blob = _src_text(150_000)
    rows = ab.run(lz4tpu_torch.compress(blob), blob,
                  ("sub2k", "p3sf6k", "noring@12288", "graph3k", "trim12k"),
                  lo=2, hi=6, rounds=3)
    assert [r["sub"] for r in rows] == [2048, 6144, 12288, 3072, 12288]
    assert all(r["ms"] > 0 for r in rows)
    assert rows[2]["passes"] is None
    assert rows[3]["passes"] == tmx.passes_for(rows[3]["n_sub"])
    assert rows[4]["passes"] == rows[4]["live_passes"]


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


# ---------------------------------------------------------------------------
# the redesigned kernels at the edges of their design (lz4tpu_torch.exp.edge)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(edge.SEGMENT_CASES))
def test_segment_decode_kernel_edges(cuda, name):
    """Kernel H6 on a chain longer than its ring with offset 65,535, on
    gaps and overlapping matches across tile edges, and on offsets
    above 65,535, against the numpy reference."""
    comp, cols, n_out, want = edge.segment_case(name)
    n0 = _kernels.LAUNCHES["segment_decode"]
    got = tsg.decode_chain_device(comp, *cols, n_out, device=cuda)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["segment_decode"] == n0 + 1
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("names,ring", [
    (("overlap1", "overlap3"), 1 << 16), (("gaps", "overlap2"), 1 << 16),
    (("gaps", "ring_far", "overlap1"), 1 << 17)])
def test_segment_decode_kernel_many_chains(cuda, names, ring):
    """Forty chains in one launch, at bases that are not 16-byte
    aligned: the ring is sized by the longest (64 KiB, or 128 KiB where
    one chain in three is longer than that)."""
    cases = [edge.segment_case(names[k % len(names)]) for k in range(40)]
    comp = np.concatenate([c[0] for c in cases])
    cols, rows, wants, cbase, obase = [], [], [], 0, 0
    for k, (c, cl, n_out, want) in enumerate(cases):
        obase += k % 5                      # a gap between chains
        cols.append(cl)
        rows.append((cl[0].size, cbase, obase, n_out))
        wants.append((obase, want))
        cbase += c.size
        obase += n_out
    assert tsg.ring_bytes_for(
        tsg.pack_chains(cols, rows, comp.size, "cpu")[3]) == ring
    got = tsg.decode_chains_device(torch.from_numpy(comp).to(cuda), cols,
                                   rows).cpu().numpy()
    for base, want in wants:
        assert np.array_equal(got[base:base + want.size], want)
    covered = np.zeros(got.size, bool)
    for base, want in wants:
        covered[base:base + want.size] = True
    assert not got[~covered].any()


@pytest.mark.parametrize("seeded", [False, True])
def test_fused_route_kernel_edges(cuda, seeded):
    """Kernel H1's route where its word gather has an edge: sources
    across a 4-byte word, a run's end, the ring's end into the window;
    two segments in one launch; a ring carried from launch to launch.
    300 substeps pass the kernel's scalar chunks (128 substeps) twice."""
    case = edge.route_case(n_sub=300)
    pos, lits, winq, scal = (torch.from_numpy(a).to(cuda) for a in case)
    n = case[0].shape[0]
    ring_in = np.random.default_rng(9).integers(0, 256, 65536, dtype=np.uint8)
    ring_dev = torch.from_numpy(ring_in).to(cuda) if seeded else None
    for segs in ([(0, n, int(seeded))], [(0, 17, 0), (17, n, int(seeded))],
                 [(0, 1, int(seeded)), (1, 3, 0), (3, n, 0)]):
        rows, ring = tfu.route(pos, lits, winq, scal,
                               segments_tensor(segs, cuda), ring_dev)
        torch.cuda.synchronize()
        want_rows, want_ring = edge.ref_route(*case, segs,
                                              ring_in if seeded else None)
        assert np.array_equal(rows.cpu().numpy(), want_rows)
        assert np.array_equal(ring.cpu().numpy(), want_ring)
    # sources below 0 and past the window's end clamp as the plain route's
    stray = edge.route_case(n_sub=20, stray=True)
    rows, ring = tfu.route(*(torch.from_numpy(a).to(cuda) for a in stray),
                           segments_tensor([(0, 20, int(seeded))], cuda),
                           ring_dev)
    want_rows, want_ring = edge.ref_route(*stray, [(0, 20, int(seeded))],
                                          ring_in if seeded else None)
    assert np.array_equal(rows.cpu().numpy(), want_rows)
    assert np.array_equal(ring.cpu().numpy(), want_ring)
    # launch to launch: [0, cut) then [cut, n) seeded by the first's ring
    whole, ring_whole = tfu.route(pos, lits, winq, scal,
                                  segments_tensor([(0, n, 0)], cuda))
    for cut in (1, 2, 3, 4, 5, 17, 128, 200):
        rows1, ring1 = tfu.route(pos[:cut], lits, winq[:cut], scal[:cut],
                                 segments_tensor([(0, cut, 0)], cuda))
        rows2, ring2 = tfu.route(pos[cut:], lits, winq[cut:], scal[cut:],
                                 segments_tensor([(0, n - cut, 1)], cuda),
                                 ring1)
        assert torch.equal(torch.cat([rows1, rows2]), whole)
        assert torch.equal(ring2, ring_whole)


# ---------------------------------------------------------------------------
# H3 resolved by pointer jumping; H1 expand at several grid sizes
# ---------------------------------------------------------------------------

def _words_text(n: int) -> bytes:
    """n bytes of word tokens of the port's own source text, seeded:
    one dense chain whose reference chains run hundreds of links deep."""
    import re

    toks = sorted(set(re.findall(
        rb"[A-Za-z_][A-Za-z0-9_]*|[^A-Za-z0-9_\s]+|\s+", _src_text(140_000))))
    rng = np.random.default_rng(5)
    return b"".join([toks[i] for i in rng.integers(0, len(toks),
                                                   n // 3)])[:n]


def _route_both(code, scal, segs, ring_in, cuda):
    """H3 on the card and route_plain on the CPU of the same inputs."""
    dev = [t.to(cuda) for t in (code, scal, segments_tensor(segs, "cpu"))]
    got = tmx._route(*dev, None if ring_in is None else ring_in.to(cuda))
    want = tmx.route_plain(code, scal, segments_tensor(segs, "cpu"), ring_in)
    torch.cuda.synchronize()
    return got[0].cpu(), got[1].cpu(), want[0], want[1]


@pytest.mark.parametrize("kind", ["src", "chains", "words"])
@pytest.mark.parametrize("seeded", [False, True])
def test_mxu2_pointer_jumping_kernel(cuda, kind, seeded):
    """H3 equals the serial plain route: one chain, independent chains
    (one segment each), 4 MiB of word tokens; zero or seeded ring."""
    blob = {"src": _src_text(300_000), "chains": _src_text(300_000),
            "words": _words_text(4 << 20)}[kind]
    kw = (dict(block_max_code=4, block_independence=True)
          if kind == "chains" else {})
    cols, ranges = _table(lz4tpu_torch.compress(blob, **kw))
    pack = tmx.pack_dense2(*cols, chain_ranges=ranges)
    seed = (torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, 65536, dtype=np.uint8)) if seeded else None)
    segs = part_segments(pack.out_spans, 0, pack.n_sub, seeded)
    rows, ring, rows_p, ring_p = _route_both(
        torch.from_numpy(pack.code), torch.from_numpy(pack.scal), segs, seed,
        cuda)
    assert torch.equal(rows, rows_p) and torch.equal(ring, ring_p)
    if not seeded:
        assert b"".join(rows.numpy()[lo * 2048:lo * 2048 + n].tobytes()
                        for (_c, lo, _hi, n) in pack.out_spans) == blob


@pytest.mark.parametrize("part_subs", [5, 37])
def test_mxu2_kernel_parts_carry_the_ring(cuda, part_subs):
    """decode_dense2_rows launch by launch, each part's ring seeding the
    next, equals the plain part loop and one launch."""
    cols, ranges = _table(lz4tpu_torch.compress(_src_text(300_000)))
    pack = tmx.pack_dense2(*cols, chain_ranges=ranges)
    rows_k, ring_k = tmx.decode_dense2_rows(pack, cuda, part_subs=part_subs)
    rows_p, ring_p = tmx.decode_dense2_rows(pack, "cpu", part_subs=part_subs)
    whole, ring_w = tmx.decode_dense2_rows(pack, cuda)
    torch.cuda.synchronize()
    assert torch.equal(rows_k.cpu(), rows_p) and torch.equal(ring_k.cpu(), ring_p)
    assert torch.equal(rows_k, whole) and torch.equal(ring_k, ring_w)


@pytest.mark.parametrize("short", [1, 10, 31, 32, 33])
def test_mxu2_kernel_short_segment_ring_out(cuda, short):
    """A segment of fewer substeps than the ring holds: ring_out is its
    substeps' blocks over the rest of ring_in."""
    cols, ranges = _table(lz4tpu_torch.compress(_src_text(300_000)))
    pack = tmx.pack_dense2(*cols, chain_ranges=ranges)
    seed = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, 65536, dtype=np.uint8))
    code = torch.from_numpy(pack.code[7:7 + short])
    scal = torch.from_numpy(pack.scal[7:7 + short])
    rows, ring, rows_p, ring_p = _route_both(code, scal, [(0, short, 1)],
                                             seed, cuda)
    assert torch.equal(rows, rows_p) and torch.equal(ring, ring_p)
    mine = np.zeros(65536, bool)
    for i in range(min(short, 32)):
        blk = (int(scal[short - 1 - i, 0]) & 255) // 8
        mine[blk * 2048:(blk + 1) * 2048] = True
    assert np.array_equal(ring.numpy()[~mine], seed.numpy()[~mine])


@pytest.mark.parametrize("n_sub", [2, 33, 257, 1025])
def test_mxu2_kernel_deepest_chain(cuda, n_sub):
    """Chains n_sub - 1 links deep: the passes_for(n_sub) passes cover
    them; also split into three segments and with a segment gap."""
    code, scal = (torch.from_numpy(a) for a in edge.deep_chain(n_sub))
    for segs in ([(0, n_sub, 0)],
                 [(0, 1, 0), (1, n_sub // 2, 1), (n_sub // 2, n_sub, 0)],
                 [(1, n_sub, 0)]):
        rows, ring, rows_p, ring_p = _route_both(code, scal, segs, None, cuda)
        assert torch.equal(rows, rows_p) and torch.equal(ring, ring_p)


def test_mxu2_kernel_counts_one_launch_a_call(cuda):
    cols, ranges = _table(lz4tpu_torch.compress(_src_text(100_000)))
    pack = tmx.pack_dense2(*cols, chain_ranges=ranges)
    n0 = _kernels.LAUNCHES["mxu2_route"]
    tmx.decode_dense2_rows(pack, cuda, part_subs=7)
    assert _kernels.LAUNCHES["mxu2_route"] == n0 + -(-pack.n_sub // 7)


def test_mxu2_decode_refuses_other_ring_rows(cuda):
    cols, ranges = _table(lz4tpu_torch.compress(_src_text(100_000)))
    pack = tmx.pack_dense2(*cols, chain_ranges=ranges)
    pack.scal[5, 0] = (int(pack.scal[5, 0]) + 8) & 255
    n0 = _kernels.LAUNCHES["mxu2_route"]
    with pytest.raises(ValueError, match="advance 8"):
        tmx.decode_dense2_rows(pack, cuda)
    assert _kernels.LAUNCHES["mxu2_route"] == n0


def _defer(cols, buf, ranges):
    out_start, ll, ls, ml, mo = cols
    return tmx.defer_dense2(out_start, ll, ml, mo, ls, buf, ranges)


def _dense_codes_both(pack, cuda, part=tmx.PART_SUBS):
    """H9's codes of a deferred pack, part by part, next to its plain
    version's on the same staged tensors: two int32 (n_sub, SUB) on the
    CPU."""
    staged = tmx.stage_dense_codes(pack, cuda)
    got, want = [], []
    for p0 in range(0, pack.n_sub, part):
        n = min(part, pack.n_sub - p0)
        got.append(tmx.dense_codes(*staged, p0, n).cpu())
        want.append(tmx.dense_codes_plain(*staged[:3], p0, n).cpu())
    tmx.raise_on_fault(staged[3])
    return torch.cat(got), torch.cat(want)


@pytest.mark.parametrize("part", [tmx.PART_SUBS, 3])
@pytest.mark.parametrize("name", sorted(edge.DENSE_CASES))
def test_dense_codes_kernel_edges(cuda, name, part):
    """H9 on its hand-made edges equals its plain version and the host
    packer, whole and in parts of 3 substeps; a match before its chain's
    start raises the host packer's ValueError after the launch, in the
    decode too, or where the caller reads the flag it was handed."""
    pack = _defer(*edge.dense_case(name))
    n0 = _kernels.LAUNCHES["dense_codes"]
    if name == "before-chain":
        staged = tmx.stage_dense_codes(pack, cuda)
        tmx.dense_codes(*staged, 0, pack.n_sub)
        with pytest.raises(ValueError,
                           match="^pack_dense2 failed with status 2$"):
            tmx.raise_on_fault(staged[3])
        with pytest.raises(ValueError,
                           match="^pack_dense2 failed with status 2$"):
            tmx.decode_dense2_rows(pack, cuda)
        # with a list the flag is handed back unread, for the caller's
        # synchronisation, and raises there
        faults = []
        tmx.decode_dense2_rows(pack, cuda, faults=faults,
                               staged=tmx.stage_dense2(pack, cuda))
        assert len(faults) == 1
        with pytest.raises(ValueError,
                           match="^pack_dense2 failed with status 2$"):
            tmx.raise_on_fault(*faults)
        return
    got, want = _dense_codes_both(pack, cuda, part)
    assert _kernels.LAUNCHES["dense_codes"] == n0 + -(-pack.n_sub // part)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), pack.packed().code)
    rows, ring = tmx.decode_dense2_rows(pack, cuda, part_subs=part)
    rows_p, ring_p = tmx.decode_dense2_rows(pack, "cpu", part_subs=part)
    torch.cuda.synchronize()
    assert torch.equal(rows.cpu(), rows_p) and torch.equal(ring.cpu(), ring_p)


def test_dense_codes_kernel_on_a_words32m_chain(cuda):
    """H9 on words32m's one mxu2 chain of 16,384 substeps (chip_smoke.py's
    corpus) against its plain version and the host packer."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data, blob = smoke.words32m(np, lz4tpu_torch)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, FOR_ALL, data)
    plan = tpl.plan_decode(buf, parsed, table)
    pack = plan.dense_pack
    assert len(plan.dense_chains) == 1 and pack.n_sub == 16_384
    got, want = _dense_codes_both(pack, cuda)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), pack.packed().code)


def test_dense_codes_kernel_on_a_lineitem_request(cuda, monkeypatch):
    """Every dense chain of one ``tpch-lineitem-1m`` request, at the
    cell's size: H9 equals its plain version and the native packer; the
    request's decode builds every dense substep's codes on the card
    (counter ``decode.dense.device_codes``) and never calls the host
    packer."""
    from lz4bench import harness
    from lz4tpu_torch import trace

    cell = harness.load_cell("tpch-lineitem-1m")
    entry = harness.entry_class(cell.traffic["entry"])(
        harness.make_requests(cell, 2**31 + 29), cell.config, cell.traffic,
        torch.device("cpu"))
    data = entry.joined[0]
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, FOR_ALL, data)
    plan = tpl.plan_decode(buf, parsed, table)
    pack = plan.dense_pack
    assert len(plan.dense_chains) > 100 and pack.n_sub > 50_000
    got, want = _dense_codes_both(pack, cuda)
    assert torch.equal(got, want)
    assert native.available()
    assert np.array_equal(got.numpy(), pack.packed().code)

    def refused(*_a, **_k):
        raise AssertionError("a CUDA decode called the host packer")

    monkeypatch.setattr(native, "pack_dense2_chain", refused)
    monkeypatch.setattr(tmx, "_pack_chain", refused)
    n0 = _kernels.LAUNCHES["dense_codes"]
    with trace.recording() as rec:
        out = lz4tpu_torch.decompress_to_device(data, verify="none")
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), entry.refs[0])
    assert rec.counters["decode.dense.device_codes"] == pack.n_sub
    assert rec.counters["decode.chains.dense"] == len(plan.dense_chains)
    assert _kernels.LAUNCHES["dense_codes"] - n0 == -(-pack.n_sub
                                                       // tmx.PART_SUBS)
    assert rec.seconds("decode.dense.codes") > 0


@pytest.mark.parametrize("n_sub", [1, 64, 131, 132, 133, 1055, 1056, 1057,
                                   2500])
def test_fused_expand_kernel_grid_sizes(cuda, n_sub):
    """H1's expand below, at and above one block a substep on every SM
    (132) and eight (1056), against expand_plain."""
    cols, ranges = _table(lz4tpu_torch.compress(_frag_text(5_200_000, 17)))
    prep = tfu.prep_fused(*cols, chain_ranges=ranges, pooled=False)
    assert prep.n_sub >= n_sub
    t = [torch.from_numpy(np.ascontiguousarray(getattr(prep, k)[:n_sub]))
         for k in ("seqrec", "scal", "patch")]
    got = tfu.expand(*(a.to(cuda) for a in t))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tfu.expand_plain(*t))


@pytest.mark.parametrize("n", [1, 2, 17, 18, 256])
def test_block_fill_kernel_shapes(cuda, n):
    """H2 at one block, z9m's 18, 256 (128 MiB) and odd counts between,
    with values whose high bits are set, against block_fill_plain and
    the expanded-copy library call."""
    vals = torch.from_numpy(np.random.default_rng(n).integers(
        -2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32))
    vals[0] = 0x7FFFFF00 | 0xAB
    n0 = _kernels.LAUNCHES["block_fill"]
    got = tsp.block_fill(vals.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["block_fill"] == n0 + 1
    want = tsp.block_fill_plain(vals)
    assert got.shape == (n * tsp.FILL_BLK,) and torch.equal(got.cpu(), want)
    lib = ((vals & 255).to(torch.uint8)[:, None]
           .expand(n, tsp.FILL_BLK).contiguous().reshape(-1))
    assert torch.equal(lib, want)


def test_span_decode_on_card_equals_cpu(cuda):
    """Seeded spans of one chain, routed by H1 from their boundary
    rings, equal the plain route's rows on the CPU and the bytes."""
    from lz4tpu_torch import spans as tsn

    blob = _frag_text(700_000, 23)
    cols, _ranges = _table(lz4tpu_torch.compress(blob))
    ll, ml, mo, ls, buf = cols
    ranges = tsn.plan_spans(len(blob), 4, min_subs=32)
    assert len(ranges) == 4
    prep = tfu.prep_fused(ll, ml, mo, ls, buf, pooled=False)
    out = bytearray()
    n0 = _kernels.LAUNCHES["fused_route"]
    for a, b in ranges:
        n = min(b * tsn.SUB, len(blob)) - a * tsn.SUB
        ring = (None if a == 0 else
                tsn.resolve_ring_bytes(ll, ml, mo, ls, buf, a * tsn.SUB))
        sl = tsn.slice_prep(prep, a, b, n)
        got = tsn.decode_span_on_device(sl, ring, a * tsn.SUB, device=cuda)
        want = tsn.decode_span_on_device(sl, ring, a * tsn.SUB, device="cpu")
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        out += want[:n].numpy().tobytes()
    assert bytes(out) == blob
    assert _kernels.LAUNCHES["fused_route"] == n0 + 4


@pytest.mark.parametrize("entries", [1, 4])
def test_sharded_decode_on_card_equals_cpu(cuda, entries):
    """decompress_sharded over entries of cuda:0, each on its own
    stream, against the same mesh on the CPU, for every tier."""
    from lz4tpu_torch import dist

    mesh = dist.Mesh([cuda] * entries)
    assert len({id(e.stream) for e in mesh.entries}) == entries
    cpu = dist.make_mesh(entries, "cpu")
    text = _frag_text(1_200_000, 29)
    for blob, kw in ((text, {}), (text, dict(block_max_code=4,
                                             block_independence=True)),
                     (bytes(2_000_000), dict(block_max_code=5,
                                             block_independence=True)),
                     (_src_text(150_000), {}), (bytes(900_000), {})):
        data = lz4tpu_torch.compress(blob, **kw)
        assert dist.decompress_sharded(data, mesh) == blob
        assert dist.decompress_sharded(data, cpu) == blob


# ---------------------------------------------------------------------------
# the device encoder: torch ops and H8 (its prefix levels); the card's
# bytes must be the CPU's
# ---------------------------------------------------------------------------

def _encode_payload() -> bytes:
    return (_frag_text(150_000, 31) + bytes(70_000) + _src_text(60_000)
            + np.random.default_rng(32).integers(0, 256, 40_000,
                                                 dtype=np.uint8).tobytes())


@pytest.mark.parametrize("backend", ["device", "device-emit"])
@pytest.mark.parametrize("kw", [{}, {"block_max_code": 4},
                                {"block_max_code": 4,
                                 "block_independence": True,
                                 "block_checksum": True}])
def test_encode_on_the_card_equals_the_cpu(cuda, backend, kw):
    blob = _encode_payload()
    got = lz4tpu_torch.compress(blob, backend=backend, device="cuda", **kw)
    assert got == lz4tpu_torch.compress(blob, backend=backend, device="cpu",
                                        **kw)
    assert lz4tpu_torch.decompress_to_device(got).cpu().numpy(
    ).tobytes() == blob


def test_encoder_passes_on_the_card_equal_the_cpu(cuda):
    from lz4tpu_torch.device import encode as enc

    d = np.frombuffer(_encode_payload(), np.uint8)
    for fn in (enc.compact_candidates, enc.match_candidates):
        assert np.array_equal(fn(d, device="cuda"), fn(d, device="cpu"))
    for a, b in zip(enc.emit_inputs(d, device="cuda"),
                    enc.emit_inputs(d, device="cpu")):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("entries", [1, 4])
def test_compress_sharded_on_the_card(cuda, entries):
    from lz4tpu_torch import dist

    blob = _encode_payload()
    mesh = dist.Mesh(["cuda:0"] * entries)
    got = dist.compress_sharded(blob, mesh, block_max_code=4)
    assert got == dist.compress_sharded(blob, dist.make_mesh(entries, "cpu"),
                                        block_max_code=4)
    assert got == lz4tpu_torch.compress(blob, backend="device",
                                        device="cpu", block_max_code=4)


def _levels_data(kind: str) -> bytes:
    n = (4 << 20) + 65536       # a default block and its history
    rng = np.random.default_rng(43)
    return {"words": lambda: _words_text(n),
            "zeros": lambda: bytes(n),
            "urandom": lambda: rng.integers(0, 256, n,
                                            dtype=np.uint8).tobytes(),
            "frag": lambda: _frag_text(n, 44),
            "n1024": lambda: _frag_text(1000, 45),
            "n5k": lambda: _words_text(5 * 1024)}[kind]()


@pytest.mark.parametrize("kind", ["words", "zeros", "urandom", "frag",
                                  "n1024", "n5k"])
def test_emit_levels_kernel(cuda, kind):
    """H8 against the plain levels on the same sorted entries: the
    encode cell's shape (n_pad 4,259,840) of word text, zeros (one group
    over every tile at every level), urandom (no group above level 4),
    fragment text; n_pad 1024 and 5 x 1024 (under a tile, and not a
    multiple of one)."""
    from lz4tpu_torch.device import emit_levels as el
    from lz4tpu_torch.device import encode as enc

    buf, _n, n_pad = enc._pad(np.frombuffer(_levels_data(kind), np.uint8),
                              cuda)
    g = enc._gram_words(buf)
    order = enc._sort_order(g)
    p_s = order.to(torch.int32)
    want = enc._level_deltas([w.gather(-1, order) for w in g], p_s)
    n0 = _kernels.LAUNCHES["emit_levels"]
    got = el.emit_levels(buf, p_s)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["emit_levels"] == n0 + 1
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (n_pad,) and got[k].dtype == torch.int32
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kw", [{"block_max_code": 4},
                                {"block_max_code": 4,
                                 "block_independence": True}])
def test_device_emit_frames_launch_h8_once_a_block(cuda, kw):
    from lz4tpu_torch import trace

    blob = _encode_payload()
    blocks = -(-len(blob) // 65536)
    n0 = _kernels.LAUNCHES["emit_levels"]
    with trace.recording() as rec:
        got = lz4tpu_torch.compress(blob, backend="device-emit",
                                    device="cuda", **kw)
    assert _kernels.LAUNCHES["emit_levels"] - n0 == blocks
    assert rec.counters["encode.levels.kernel"] == blocks
    assert got == lz4tpu_torch.compress(blob, backend="device-emit",
                                        device="cpu", **kw)
