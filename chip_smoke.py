#!/usr/bin/env python3
"""Drive lz4tpu_torch's decode paths on one NVIDIA GPU and check them.

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
g++:  ``python3 chip_smoke.py``.  It

1. prints the environment, the card and its power limit;
2. builds the CUDA kernels (csrc/*.cu, nvcc, sm_90a) and the native
   host engine from the checkout, and times the build;
3. runs each kernel and its plain PyTorch version on the card and
   requires equal values (tolerance 0: integers and bytes), at the main
   path's shapes where the plain version can run there and at a small
   shape where it is a Python loop; at the main path's shapes the xxh32
   kernels must equal the native host hash and the segment kernel the
   original bytes.  Kernels are timed with CUDA events, and each gets
   the least time the card could take for the same work (its bound);
4. drives three paths over seeded in-process corpora, the launch
   counters set to 0 before each and read after it:
   ``decompress_to_device(verify="host")``,
   ``decompress_to_device(verify="device")`` and ``decompress_device``
   (engines auto / pallas / resolve, and ``decompress(backend=
   "device")``), requiring the original bytes, the planned engines and
   the kernels each path must launch; then times ``verify="host"``
   against ``verify="device"`` end to end in alternating turns;
5. checks that corrupted frames raise what
   ``lz4tpu_torch.decompress_host`` raises, under both verify modes;
6. times the device content checksum against a fetch and the native
   host hash, size by size (why the port has no small-fetch branch);
7. prints one JSON line with every kernel, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits nonzero before the last line.  Without CUDA, or
outside a checkout of the repository, it exits nonzero at once.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
TOL = 0          # integer and byte outputs compare exactly
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device-memory rate (data sheet)

KERNELS = {      # name -> (source, TPU kernel it replaces)
    "fused_expand": ("lz4tpu_torch/csrc/fused.cu",
                     "lz4tpu/device/fused.py:787"),
    "fused_route": ("lz4tpu_torch/csrc/fused.cu",
                    "lz4tpu/device/fused.py:787"),
    "mxu2_route": ("lz4tpu_torch/csrc/mxu2.cu",
                   "lz4tpu/device/mxu2.py:184"),
    "block_fill": ("lz4tpu_torch/csrc/block_fill.cu",
                   "lz4tpu/device/sparse_decode.py:228"),
    "xxh32_stream": ("lz4tpu_torch/csrc/xxh32.cu",
                     "lz4tpu/device/xxh32_pallas.py:58"),
    "xxh32_blocks": ("lz4tpu_torch/csrc/xxh32.cu",
                     "lz4tpu/device/xxh32_pallas.py:278"),
    "segment_decode": ("lz4tpu_torch/csrc/segment.cu",
                       "lz4tpu/device/pallas_decode.py:162"),
}
ENGINE_KERNELS = {"fused": ("fused_expand", "fused_route"),
                  "dense": ("mxu2_route",)}


# The xxh32 chain alone: n_rounds dependent lane updates in registers, no
# memory on the way.  Its time per round is the least any kernel on this
# card can take per stripe of one chain, so it gives the xxh32 kernels
# their bound.  A measurement of this script, not a kernel of the package.
PROBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void chain_probe(long long n_rounds, unsigned* state) {
  unsigned s = state[threadIdx.x];
  const unsigned wp = (s | 1u) * 2246822519u;
#pragma unroll 8
  for (long long i = 0; i < n_rounds; ++i)
    s = __funnelshift_l(s + wp, s + wp, 13) * 2654435761u;
  state[threadIdx.x] = s;
}
extern "C" int chain_probe_launch(long long n_rounds, void* state,
                                  void* stream) {
  chain_probe<<<1, 4, 0, static_cast<cudaStream_t>(stream)>>>(
      n_rounds, static_cast<unsigned*>(state));
  return int(cudaGetLastError());
}
"""


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# corpora (made in-process from fixed seeds)
# ---------------------------------------------------------------------------

def frag_text(np, n, n_frag, lo, hi, seed) -> bytes:
    """n bytes drawn uniformly from n_frag printable fragments of lo..hi
    bytes (seeded)."""
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(lo, hi + 1)),
                          dtype=np.uint8).tobytes() for _ in range(n_frag)]
    mean = np.mean([len(f) for f in frags])
    picks = rng.integers(0, n_frag, int(n / mean * 1.1) + 16)
    out = b"".join(frags[i] for i in picks)
    need(len(out) >= n, "fragment corpus came out short")
    return out[:n]


def repo_text(n) -> bytes:
    """The checkout's own .py/.cpp text in sorted path order (program
    files only, so the corpus changes when the code does and not with
    the documents; build outputs and unpacked copies are left out)."""
    skip = {"build", "__pycache__", "_checkout", "chiprun_out"}
    files = sorted(
        p for p in HERE.rglob("*")
        if p.suffix in (".py", ".cpp") and p.is_file()
        and not any(part.startswith(".") or part in skip
                    for part in p.relative_to(HERE).parts))
    blob = b"".join(p.read_bytes() for p in files)
    need(len(blob) >= n, f"repo text is {len(blob)} bytes, need {n}")
    return blob[:n]


def corpora(np, lt):
    """name -> (compressed, original, expected engine mix, block fill,
    blocks carry checksums)"""
    z9m = bytes(9_437_166)
    b35 = np.random.default_rng(0).integers(
        0, 256, 3_500_000, dtype=np.uint8).tobytes()
    frag1m = frag_text(np, 1_137_664, 8192, 3, 8, 11)
    src1m = repo_text(1 << 20)
    frag32m = frag_text(np, 32 << 20, 2048, 5, 39, 12)
    frag2m = frag_text(np, 2 << 20, 8192, 3, 8, 13)
    c = lt.compress
    return {
        "z9m": (c(z9m), z9m, {"sparse": 1}, True, False),
        "b3.5m": (c(b35), b35, {"sparse": 1}, False, False),
        "frag1m": (c(frag1m), frag1m, {"fused": 1}, False, False),
        "src1m": (c(src1m), src1m, {"dense": 1}, False, False),
        "frag32m": (c(frag32m), frag32m, {"fused": 1}, False, False),
        "frag32m-indep": (c(frag32m, block_independence=True), frag32m,
                          {"fused": 8}, False, False),
        "frag2m-bsum": (c(frag2m, block_checksum=True, content_size=True,
                          block_max_code=5), frag2m, {"fused": 1}, False,
                        True),
        "frag2m-legacy": (c(frag2m, frame_format="legacy"), frag2m,
                          {"fused": 1}, False, False),
        # 512 linked 64 KiB blocks, each with a checksum, one chain
        "frag32m-bsum64k": (c(frag32m, block_checksum=True,
                              block_max_code=4), frag32m, {"fused": 1},
                            False, True),
    }


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps):
    """Median of CUDA-event timings of fn() after one warm-up call.

    Each timed call is queued behind a ~1 ms spin kernel, so the start
    event fires after the host has enqueued fn's launches: a kernel's
    time is its device time, not the wrapper's Python overhead (a
    function that synchronises inside, like the plain loops, is timed
    as it runs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)      # ~1 ms of SM cycles
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(torch, fn, reps):
    """Median host-clock time of fn() ended by a synchronise, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - s))
    return statistics.median(times)


def start_probe_build(_kernels):
    """Start nvcc on the chain probe; returns (process, library path)."""
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _kernels.BUILD_DIR / "chain_probe.cu"
    src.write_text(PROBE_CU)
    so = _kernels.BUILD_DIR / "libchain_probe.so"
    proc = subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(so),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, so


def load_probe(torch, proc, so):
    """The probe as probe(n_rounds), once its build has ended."""
    import ctypes

    log = proc.communicate()[0]
    need(proc.returncode == 0, f"nvcc failed on the chain probe:\n{log}")
    fn = ctypes.CDLL(str(so)).chain_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    state = torch.arange(1, 5, dtype=torch.int32, device="cuda")

    def probe(n_rounds):
        status = fn(n_rounds, state.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        need(status == 0, f"chain probe launch failed ({status})")
    return probe


def max_abs_err(torch, a, b) -> int:
    need(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def plan_of(np, lt, tpl, data):
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lt.FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data,
                                pooled_cols=True)
    stats = tpl.DecodeStats()
    plan = tpl.plan_decode(buf, parsed, table, stats)
    return buf, parsed, table, plan, stats


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(torch, np, lt, tpl, corp, dev, name_card, probe):
    """Each kernel against its plain version, timed, with its bound."""
    from lz4tpu_torch import native
    from lz4tpu_torch.device import fused as fu
    from lz4tpu_torch.device import mxu2 as mx
    from lz4tpu_torch.device import segment_decode as sg
    from lz4tpu_torch.device import sparse_decode as sp
    from lz4tpu_torch.device import to_device
    from lz4tpu_torch.device import xxh32_cuda as xx
    from lz4tpu_torch.device.ring import part_segments, segments_tensor

    rows = {}

    def record(name, err, ms, plain_ms, bound_ms, bound_by, shape,
               plain_shape=None, library_ms=None):
        need(err <= TOL, f"{name}: kernel differs from plain version "
                         f"(max abs err {err})")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": library_ms, "shape": shape,
                      "plain_shape": plain_shape or shape}
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"[kernel] {name}: equal to plain (max_abs_err {err}, tol "
              f"{TOL}); kernel {ms:.4f} ms at {shape}, bound "
              f"{bound_ms:.4f} ms ({bound_by}), plain {plain_ms:.4f} ms at "
              f"{plain_shape or shape}{lib} [{name_card}]", flush=True)

    # H1 on frag1m: one fused chain, 556 substeps
    _buf, _p, _t, plan, _st = plan_of(np, lt, tpl, corp["frag1m"][0])
    prep = plan.fused_prep
    need(prep is not None and len(plan.fused_chains) == 1,
         "frag1m did not plan as one fused chain")
    n = prep.n_sub
    t = {k: torch.from_numpy(np.ascontiguousarray(getattr(prep, k)[:n])
                             ).to(dev)
         for k in ("seqrec", "scal", "patch", "winq")}
    lits = torch.from_numpy(prep.lits).to(dev)
    segs = segments_tensor(part_segments(prep.out_spans, 0, n, False), dev)
    pos_k = fu.expand(t["seqrec"], t["scal"], t["patch"])
    pos_p = fu.expand_plain(t["seqrec"], t["scal"], t["patch"])
    torch.cuda.synchronize()
    shape = f"frag1m, {n} substeps"
    record("fused_expand", max_abs_err(torch, pos_k, pos_p),
           cuda_ms(torch, lambda: fu.expand(
               t["seqrec"], t["scal"], t["patch"]), 20),
           cuda_ms(torch, lambda: fu.expand_plain(
               t["seqrec"], t["scal"], t["patch"]), 5),
           1e3 * nbytes(t["seqrec"], t["scal"], t["patch"], pos_k)
           / HBM_BYTES_PER_S, "bytes", shape)
    out_k, ring_k = fu.route(pos_k, lits, t["winq"], t["scal"], segs)
    out_p, ring_p = fu.route_plain(pos_p, lits, t["winq"], t["scal"], segs)
    torch.cuda.synchronize()
    need(torch.equal(ring_k, ring_p), "fused_route: ring_out differs")
    n_out = prep.out_spans[0][3]
    need(out_k[:n_out].cpu().numpy().tobytes() == corp["frag1m"][1],
         "fused_route: frag1m bytes differ from the original")
    record("fused_route", max_abs_err(torch, out_k, out_p),
           cuda_ms(torch, lambda: fu.route(
               pos_k, lits, t["winq"], t["scal"], segs), 20),
           cuda_ms(torch, lambda: fu.route_plain(
               pos_p, lits, t["winq"], t["scal"], segs), 2),
           1e3 * nbytes(pos_k, lits, t["winq"], t["scal"], segs, out_k,
                        ring_k) / HBM_BYTES_PER_S, "bytes", shape)
    # the split entry point (K3a + K3b): H1's two launches in one call
    rows_s, ring_s = fu.decode_split(
        t["seqrec"], lits, t["winq"], t["scal"], t["patch"], n_sub=n)
    torch.cuda.synchronize()
    need(torch.equal(rows_s, out_k) and torch.equal(ring_s, ring_k),
         "decode_split differs from expand + route")
    print(f"[kernel] decode_split (fused_expand + fused_route in one "
          f"call): equal on {shape}", flush=True)

    # H3 on src1m: one mxu2 chain, 512 substeps
    _buf, _p, _t, plan, _st = plan_of(np, lt, tpl, corp["src1m"][0])
    pack = plan.dense_pack
    need(pack is not None and len(plan.dense_chains) == 1,
         "src1m did not plan as one mxu2 chain")
    code = torch.from_numpy(pack.code).to(dev)
    scal = torch.from_numpy(pack.scal).to(dev)
    segs = segments_tensor(part_segments(pack.out_spans, 0, pack.n_sub,
                                         False), dev)
    out_k, ring_k = mx.route(code, scal, segs)
    out_p, ring_p = mx.route_plain(code, scal, segs)
    torch.cuda.synchronize()
    need(torch.equal(ring_k, ring_p), "mxu2_route: ring_out differs")
    record("mxu2_route", max_abs_err(torch, out_k, out_p),
           cuda_ms(torch, lambda: mx.route(code, scal, segs), 20),
           cuda_ms(torch, lambda: mx.route_plain(code, scal, segs), 2),
           1e3 * nbytes(code, scal, segs, out_k, ring_k) / HBM_BYTES_PER_S,
           "bytes", f"src1m, {pack.n_sub} substeps")

    # H2 on z9m: the block-fill plan's 18 blocks of 512 KiB
    _buf, _p, _t, plan, _st = plan_of(np, lt, tpl, corp["z9m"][0])
    ((_chain, prog),) = plan.sparse
    fill = sp._plan_block_fill(prog.ops, prog.n_out)
    need(fill is not None, "z9m did not plan a block fill")
    vals = torch.from_numpy(fill[0].reshape(-1)).to(dev)
    got_k = sp.block_fill(vals)
    got_p = sp.block_fill_plain(vals)
    torch.cuda.synchronize()
    record("block_fill", max_abs_err(torch, got_k, got_p),
           cuda_ms(torch, lambda: sp.block_fill(vals), 50),
           cuda_ms(torch, lambda: sp.block_fill_plain(vals), 50),
           1e3 * nbytes(vals, got_k) / HBM_BYTES_PER_S, "bytes",
           f"z9m, {vals.shape[0]} blocks of 512 KiB",
           library_ms=cuda_ms(
               torch, lambda: (vals & 255).to(torch.uint8)
               .repeat_interleave(sp.FILL_BLK), 50))

    # the xxh32 chain alone: time per round of the dependent lane update
    rounds = 4_000_000
    round_ns = 1e6 * cuda_ms(
        torch, lambda: probe(rounds), 5) / rounds
    print(f"[kernel] xxh32 chain probe: {round_ns:.3f} ns per dependent "
          f"lane update (4 threads, registers only, {rounds} rounds) "
          f"[{name_card}]", flush=True)

    # H4: small shape against plain (odd lo, odd tail, K6 and K7 entry),
    # then frag32m's decoded bytes against the native host hash
    rng = np.random.default_rng(21)
    small = torch.from_numpy(rng.integers(0, 256, 70_001, dtype=np.uint8)
                             ).to(dev)
    lo, n_str = 13, (70_001 - 13) // 16
    seed = xx.seed_state(dev)
    k6_k = xx.xxh32_stream(small, lo, n_str, seed)          # K6: seed state
    k6_p = xx.xxh32_stream_plain(small, lo, n_str, seed)
    half = n_str // 2
    mid_k = xx.xxh32_stream(small, lo, half, seed)
    k7_k = xx.xxh32_stream(small, lo + 16 * half, n_str - half, mid_k)
    k7_p = xx.xxh32_stream_plain(small, lo + 16 * half, n_str - half, mid_k)
    torch.cuda.synchronize()
    need(torch.equal(k7_k, k6_k), "xxh32_stream: carried state differs "
                                  "from one pass")
    err = max(max_abs_err(torch, k6_k, k6_p), max_abs_err(torch, k7_k, k7_p))
    small_np = small.cpu().numpy()
    need(xx.xxh32_of_device_array(small, lo, 70_001)
         == native.native_xxh32(small_np[lo:]),
         "xxh32_of_device_array: small range differs from the native hash")
    blob = corp["frag32m"][1]
    big = to_device(np.frombuffer(blob, np.uint8), dev)
    for lo_b in (0, 7):
        need(xx.xxh32_of_device_array(big, lo_b, len(blob))
             == native.native_xxh32(blob[lo_b:]),
             f"xxh32_of_device_array: frag32m[{lo_b}:] differs from the "
             "native hash")
    b35 = np.frombuffer(corp["b3.5m"][1], np.uint8)
    need(xx.xxh32_device(b35, device=dev) == native.native_xxh32(b35),
         "xxh32_device: b3.5m differs from the native hash")
    n_big = len(blob) // 16
    ms_odd = cuda_ms(torch, lambda: xx.xxh32_stream(big, 7, n_big - 1, seed),
                     3)
    ms_big = cuda_ms(torch, lambda: xx.xxh32_stream(big, 0, n_big, seed), 5)
    print(f"[kernel] xxh32_stream at lo=7: {ms_odd:.4f} ms for "
          f"{n_big - 1} stripes", flush=True)
    record("xxh32_stream", err, ms_big,
           cuda_ms(torch, lambda: xx.xxh32_stream_plain(
               small, lo, n_str, seed), 1),
           max(n_big * round_ns * 1e-6,
               1e3 * (len(blob) + 32) / HBM_BYTES_PER_S),
           "operations", f"frag32m decoded, one chain of {n_big} stripes",
           plain_shape=f"{n_str} stripes at lo={lo}")
    print(f"[kernel] xxh32_stream: {len(blob) / ms_big / 1e6:.3f} GB/s on "
          f"one 32 MiB chain [{name_card}]", flush=True)
    del big

    # H5: small shape against plain, then frag32m's 512 checksummed blocks
    offs = torch.tensor([0, 7, 1001, 30_000, 69_990], dtype=torch.int64,
                        device=dev)
    lens = torch.tensor([3, 15, 4099, 40_001, 11], dtype=torch.int64,
                        device=dev)
    st_k = xx.xxh32_blocks(small, offs, lens)
    st_p = xx.xxh32_blocks_plain(small, offs, lens)
    torch.cuda.synchronize()
    err = max_abs_err(torch, st_k, st_p)
    need(xx.xxh32_blocks_device(small, offs.tolist(), lens.tolist())
         == [native.native_xxh32(small_np[o:o + ln])
             for o, ln in zip(offs.tolist(), lens.tolist())],
         "xxh32_blocks_device: small blocks differ from the native hash")
    data = corp["frag32m-bsum64k"][0]
    buf = np.frombuffer(data, np.uint8)
    blks = [b for f in tpl.parse_frames(buf, lt.FOR_ALL).frames
            for b in f.blocks]
    need(len(blks) == 512 and all(b.checksum is not None for b in blks),
         f"frag32m-bsum64k has {len(blks)} blocks, expected 512 with "
         "checksums")
    comp_dev = to_device(buf, dev)
    b_off = [b.comp_off for b in blks]
    b_len = [b.comp_len for b in blks]
    need(xx.xxh32_blocks_device(comp_dev, b_off, b_len)
         == [b.checksum for b in blks],
         "xxh32_blocks_device: frag32m-bsum64k digests differ from the "
         "frame's block checksums")
    off_t = torch.tensor(b_off, dtype=torch.int64, device=dev)
    len_t = torch.tensor(b_len, dtype=torch.int64, device=dev)
    record("xxh32_blocks", err,
           cuda_ms(torch, lambda: xx.xxh32_blocks(comp_dev, off_t, len_t),
                   20),
           cuda_ms(torch, lambda: xx.xxh32_blocks_plain(small, offs, lens),
                   1),
           max(max(b_len) // 16 * round_ns * 1e-6,
               1e3 * (sum(b_len) + 32 * len(blks)) / HBM_BYTES_PER_S),
           "operations",
           f"frag32m-bsum64k, 512 blocks, longest {max(b_len) // 16} "
           "stripes",
           plain_shape=f"5 blocks, longest {int(lens.max()) // 16} stripes")

    # H6: small shape against plain, then src1m and frag1m (one chain
    # each) and 32 independent chains against the original bytes
    def tables(data):
        buf, parsed, table, _plan, _st = plan_of(np, lt, tpl, data)
        chains = [c for c in tpl._chains_of(table) if c.out_hi > c.out_lo]
        cols, rws = tpl._segment_tables(parsed, table, chains)
        comp = to_device(buf, dev)
        need(sg.covers(cols, rws), "an LZ4 table leaves output unwritten")
        seqs, ch, total = sg.pack_chains(cols, rws, comp.shape[0], dev)
        return comp, seqs, ch, total, cols

    small_text = repo_text(1 << 16)
    comp, seqs, ch, total, _c = tables(lt.compress(small_text))
    sm_k = sg.segment_decode(comp, seqs, ch, total, zero_fill=False)
    sm_p = sg.segment_decode_plain(comp, seqs, ch, total)
    torch.cuda.synchronize()
    err = max_abs_err(torch, sm_k, sm_p)
    need(sm_k.cpu().numpy().tobytes() == small_text,
         "segment_decode: 64 KiB text differs from the original")
    plain_ms = cuda_ms(
        torch, lambda: sg.segment_decode_plain(comp, seqs, ch, total), 1)
    plain_shape = f"64 KiB of src text, {seqs.shape[1]} sequences"
    indep = frag_text(np, 2 << 20, 8192, 3, 8, 14)
    for name, data, blob in (
            ("frag1m", corp["frag1m"][0], corp["frag1m"][1]),
            ("indep2m", lt.compress(indep, block_max_code=4,
                                    block_independence=True), indep),
            ("src1m", corp["src1m"][0], corp["src1m"][1])):
        comp, seqs, ch, total, cols = tables(data)
        got = sg.segment_decode(comp, seqs, ch, total, zero_fill=False)
        torch.cuda.synchronize()
        need(got.cpu().numpy().tobytes() == blob,
             f"segment_decode: {name} differs from the original")
        ms = cuda_ms(torch, lambda: sg.segment_decode(
            comp, seqs, ch, total, zero_fill=False), 5)
        lit_bytes = sum(int(c[2].sum()) for c in cols)
        bound = 1e3 * (lit_bytes + nbytes(seqs, ch) + total) / HBM_BYTES_PER_S
        shape = (f"{name}, {ch.shape[0]} chain(s), {seqs.shape[1]} "
                 "sequences")
        if name != "src1m":
            print(f"[kernel] segment_decode: {ms:.4f} ms at {shape}, bound "
                  f"{bound:.4f} ms (bytes) [{name_card}]", flush=True)
    record("segment_decode", err, ms, plain_ms, bound, "bytes", shape,
           plain_shape=plain_shape)
    return rows


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

def stages_of(torch, np, lt, tpl, data, dev, mode):
    """One pass of decompress_to_device's steps with the host clock,
    synchronised after each: name -> ms."""
    from lz4tpu_torch.device import to_device

    def lap(t0):
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    out = {}
    t0 = time.perf_counter()
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lt.FOR_ALL)
    out["parse"] = lap(t0)
    t0 = time.perf_counter()
    table = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data,
                                pooled_cols=True)
    out["scan"] = lap(t0)
    comp_dev = None
    if mode == "device" and any(b.checksum is not None
                                for f in parsed.frames for b in f.blocks):
        t0 = time.perf_counter()
        comp_dev = to_device(buf, dev)
        out["stage_comp"] = lap(t0)
    t0 = time.perf_counter()
    plan = tpl.plan_decode(buf, parsed, table)
    out["plan"] = lap(t0)
    t0 = time.perf_counter()
    segs = tpl.build_device_segments(buf, table, plan, dev,
                                     comp_dev=comp_dev)
    res = tpl.assemble_device_segments(segs, table.n_out, dev)
    out["engines"] = lap(t0)
    if mode == "host":
        t0 = time.perf_counter()
        host = res.cpu().numpy()
        out["d2h"] = lap(t0)
        t0 = time.perf_counter()
        tpl._verify_checksums(buf, parsed, host, table)
        out["verify"] = lap(t0)
    else:
        t0 = time.perf_counter()
        tpl._verify_checksums_device(buf, parsed, res, table,
                                     comp_dev=comp_dev)
        out["verify"] = lap(t0)
    return out


def to_device_path(torch, np, lt, tpl, _kernels, corp, dev, name_card,
                   mode):
    """decompress_to_device(verify=mode) over the corpora; returns the
    launch counts of this path."""
    _kernels.reset_launches()
    total = dict.fromkeys(_kernels.LAUNCHES, 0)
    for name, (data, blob, engines, fills, bsums) in corp.items():
        if mode == "host" and name == "frag32m-bsum64k":
            continue                # the verify="device" pass's own corpus
        before = dict(_kernels.LAUNCHES)
        _b, _p, _t, _plan, stats = plan_of(np, lt, tpl, data)
        need(stats.engine_chains == engines,
             f"{name}: planned {stats.engine_chains}, expected {engines}")
        e2e = []
        for _ in range(2):
            s = time.perf_counter()
            res = lt.decompress_to_device(data, device="cuda", verify=mode)
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - s)
        need(res.is_cuda and res.dtype == torch.uint8
             and res.shape == (len(blob),), f"{name}: bad result tensor")
        need(res.cpu().numpy().tobytes() == blob,
             f"{name}: decompress_to_device(verify={mode!r}) differs from "
             "the original")
        ran = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        for k, v in ran.items():
            total[k] += v
        want = [k for e in engines for k in ENGINE_KERNELS.get(e, ())]
        if fills:
            want.append("block_fill")
        if mode == "device":
            if name != "frag2m-legacy":     # legacy frames carry no
                want.append("xxh32_stream")     # content checksum
            if bsums:
                want.append("xxh32_blocks")
        for k in want:
            need(ran[k] > 0, f"{name}: kernel {k} was not launched under "
                             f"verify={mode!r}")
        # the stage timing replays the steps by hand: its launches are
        # not the entry point's and stay out of the path's count
        st = stages_of(torch, np, lt, tpl, data, dev, mode)
        e2e_s = statistics.median(e2e)
        print(f"[e2e] {name}: comp {len(data)} B -> {len(blob)} B, "
              f"engines {engines}, end-to-end {1e3 * e2e_s:.3f} ms = "
              f"{len(blob) / e2e_s / 1e9:.3f} GB/s (median of 2, "
              f"verify={mode!r}), launches "
              f"{ {k: v for k, v in ran.items() if v} } [{name_card}]",
              flush=True)
        print(f"[stages] {name} verify={mode!r}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
              + f" ms [{name_card}]", flush=True)
    return total


def verify_compare(torch, lt, corp, name_card, pairs=5):
    """verify="host" against verify="device" end to end, in turns inside
    one run (the order alternates pair by pair): median and range."""
    for name in ("z9m", "frag1m", "frag32m", "frag32m-indep", "frag2m-bsum"):
        data = corp[name][0]
        ms = {"host": [], "device": []}
        for i in range(pairs):
            for mode in (("host", "device"), ("device", "host"))[i % 2]:
                s = time.perf_counter()
                lt.decompress_to_device(data, device="cuda", verify=mode)
                torch.cuda.synchronize()
                ms[mode].append(1e3 * (time.perf_counter() - s))
        print(f"[verify] {name}: " + " against ".join(
            f"verify={mode!r} {statistics.median(t):.3f} ms "
            f"({min(t):.3f}..{max(t):.3f})" for mode, t in ms.items())
            + f" (median and range of {pairs}, in turns) [{name_card}]",
            flush=True)


def decompress_device_path(torch, np, lt, tpl, _kernels, corp, dev,
                           name_card):
    """decompress_device: engine auto on every corpus, pallas on src1m,
    frag1m and 32 independent chains, resolve on frag1m, and
    decompress(backend="device") once."""
    _kernels.reset_launches()

    def timed(fn):
        s = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - s)

    for name, (data, blob, engines, _f, _b) in corp.items():
        if name == "frag32m-bsum64k":
            continue
        st = tpl.DecodeStats()
        out, ms = timed(lambda: lt.decompress_device(data, stats=st))
        need(out == blob, f"{name}: decompress_device differs from the "
                          "original")
        need(st.engine_chains == engines,
             f"{name}: decompress_device ran {st.engine_chains}")
        print(f"[device] {name}: engine='auto' {ms:.3f} ms, device_s "
              f"{1e3 * st.device_s:.3f} ms [{name_card}]", flush=True)
    indep = frag_text(np, 2 << 20, 8192, 3, 8, 14)
    cases = [("src1m", corp["src1m"][0], corp["src1m"][1]),
             ("frag1m", corp["frag1m"][0], corp["frag1m"][1]),
             ("indep2m (32 chains)",
              lt.compress(indep, block_max_code=4, block_independence=True),
              indep)]
    for name, data, blob in cases:
        n0 = _kernels.LAUNCHES["segment_decode"]
        out, ms = timed(lambda: lt.decompress_device(data, engine="pallas"))
        need(out == blob, f"{name}: engine='pallas' differs from the "
                          "original")
        need(_kernels.LAUNCHES["segment_decode"] == n0 + 1,
             f"{name}: engine='pallas' did not launch segment_decode once")
        print(f"[device] {name}: engine='pallas' {ms:.3f} ms "
              f"[{name_card}]", flush=True)
    data, blob = corp["frag1m"][0], corp["frag1m"][1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, ms = timed(lambda: lt.decompress_device(data, engine="resolve"))
    peak = torch.cuda.max_memory_allocated() - base
    need(out == blob, "frag1m: engine='resolve' differs from the original")
    print(f"[device] frag1m: engine='resolve' {ms:.3f} ms, peak device "
          f"memory {peak} B = {peak / len(blob):.1f} B per output byte "
          f"[{name_card}]", flush=True)
    out, ms = timed(lambda: lt.decompress(corp["frag2m-bsum"][0],
                                          backend="device"))
    need(out == corp["frag2m-bsum"][1],
         "decompress(backend='device') differs from the original")
    print(f"[device] frag2m-bsum: decompress(backend='device') {ms:.3f} ms "
          f"[{name_card}]", flush=True)
    return dict(_kernels.LAUNCHES)


def error_phase(lt, corp):
    block = bytearray(corp["frag2m-bsum"][0])
    block[300] ^= 0x20          # inside block 0, under its checksum
    content = bytearray(corp["frag1m"][0])
    content[-1] ^= 0x01         # the content checksum
    for what, data in (("corrupted block", bytes(block)),
                       ("flipped content checksum", bytes(content))):
        try:
            lt.decompress_host(data)
        except lt.Lz4Error as e:
            want = e
        else:
            raise SmokeFailure(f"host decode accepted the {what}")
        for mode in ("host", "device"):
            try:
                lt.decompress_to_device(data, device="cuda", verify=mode)
            except lt.Lz4Error as e:
                got = e
            else:
                raise SmokeFailure(f"verify={mode!r} decoded the {what}")
            need(type(got) is type(want) and str(got) == str(want),
                 f"error parity ({what}, verify={mode!r}): "
                 f"{type(got).__name__}({got}) vs "
                 f"{type(want).__name__}({want})")
        print(f"[errors] {what}: {type(want).__name__}: {want} (same class "
              "and message from decompress_host and both verify modes)",
              flush=True)


def small_fetch_phase(torch, np, corp, dev, name_card):
    """Device content checksum against fetch + native hash, by size."""
    from lz4tpu_torch import native
    from lz4tpu_torch.device import to_device
    from lz4tpu_torch.device import xxh32_cuda as xx

    blob = np.frombuffer(corp["frag32m"][1], np.uint8)
    arr = to_device(blob, dev)
    for kib in (4, 16, 64, 256, 1024, 4096, 8192, 16384, 32768):
        n = kib << 10
        hi = min(7 + n, blob.size)
        lo = hi - n
        want = native.native_xxh32(blob[lo:hi])
        need(xx.xxh32_of_device_array(arr, lo, hi) == want,
             f"xxh32_of_device_array differs at {kib} KiB")
        dev_ms = host_ms(
            torch, lambda: xx.xxh32_of_device_array(arr, lo, hi), 5)
        fetch_ms = host_ms(torch, lambda: native.native_xxh32(
            arr[lo:hi].cpu().numpy()), 5)
        print(f"[small_fetch] {kib} KiB: device kernel {dev_ms:.4f} ms, "
              f"fetch + native hash {fetch_ms:.4f} ms (host clock, "
              f"median of 5) [{name_card}]", flush=True)


def main() -> int:
    if not (HERE / "lz4tpu_torch" / "csrc").is_dir():
        print("chip_smoke: lz4tpu_torch/ not found beside the script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import numpy as np

    import lz4tpu_torch as lt
    import lz4tpu_torch.pipeline as tpl
    from lz4tpu_torch import _kernels, native

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    probe_build = start_probe_build(_kernels)
    _kernels.lib()
    t1 = time.perf_counter()
    probe = load_probe(torch, *probe_build)
    need(native.available(), "native host engine failed to build")
    t2 = time.perf_counter()
    need(pathlib.Path(native._SRC).resolve()
         == HERE / "lz4tpu_torch" / "native" / "lz4core.cpp",
         f"native engine built from {native._SRC}")
    ptxas = [ln.strip() for ln in
             (_kernels.BUILD_DIR / "nvcc.log").read_text().splitlines()
             if "Used" in ln]
    print(f"[build] CUDA kernels {t1 - t0:.2f} s (nvcc, sm_90a, one process "
          f"per source), native engine {t2 - t1:.2f} s", flush=True)
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)

    t0 = time.perf_counter()
    corp = corpora(np, lt)
    print(f"[corpora] {len(corp)} made and compressed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rows = kernel_phase(torch, np, lt, tpl, corp, dev, card, probe)
    paths = {}
    paths["verify_host"] = to_device_path(
        torch, np, lt, tpl, _kernels, corp, dev, card, "host")
    paths["verify_device"] = to_device_path(
        torch, np, lt, tpl, _kernels, corp, dev, card, "device")
    paths["decompress_device"] = decompress_device_path(
        torch, np, lt, tpl, _kernels, corp, dev, card)
    verify_compare(torch, lt, corp, card)
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
    for name, n in launches.items():
        need(n > 0, f"kernel {name} was never launched by a path")
    error_phase(lt, corp)
    small_fetch_phase(torch, np, corp, dev, card)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name],
         "launches_by_path": {p: c[name] for p, c in paths.items()},
         **rows[name]}
        for name, (src, tpu) in KERNELS.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
