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
4. drives eight paths over seeded in-process corpora, the launch
   counters set to 0 before each and read after it:
   ``decompress_to_device(verify="host")``,
   ``decompress_to_device(verify="device")``, ``decompress_device``
   (engines auto / pallas / resolve, and ``decompress(backend=
   "device")``), the A/B harness of the mxu2 route variants
   (``lz4tpu_torch.exp.ab``, short setting), one
   ``DecodeSession(max_inflight=4)`` answering every corpus three ways,
   and ``dist.decompress_sharded`` on a one-entry mesh and on four
   entries of cuda:0 (each on its own stream), requiring the original
   bytes, the planned engines or sharding tier and the kernels each
   path must launch; ``numpy_prep`` runs these entry points again with
   the native host engine off (``native.available()`` False, its prep,
   pack and resolve functions refusing), so the numpy host prep feeds
   the same kernels, and times its ``plan`` against the native one's;
   an eighth path encodes: ``compress(backend=
   "device"|"device-emit")`` on the card against the same calls on the
   CPU, ``dist.compress_sharded`` on both meshes against
   ``compress(backend="device")``, every frame decoded back on the card,
   and ``python -m lz4tpu_torch.cli lz4-bench`` as subprocesses; then
   times ``verify="host"`` against
   ``verify="device"``, the session
   against a serial loop (with the serial host-stage rate beside them),
   and ``decompress_to_device`` against the sharded decode on both
   meshes, end to end in alternating turns, pinned staging against the
   pageable copy, and takes the device busy share with torch.profiler
   (and whether the four span units' routes overlap on the card); times
   the device encoder's passes on one 4 MiB block stage by stage, its
   host emitters, peak device memory and end-to-end encode rates;
5. runs the port as a user installs it (``wheel_phase``): the wheel
   built from a copy of the checkout, ``pip install --target`` into a
   temporary directory, and one process with only that tree on its
   path building the kernels into the tree's ``_build/`` and decoding
   the main path's corpora on the card (every decode kernel launched,
   the device encoder's frames of ``backend="device"`` and
   ``"device-emit"`` decoded back, no host fallback, every
   output equal to the installed host engine's), then the installed
   ``lz4tpu-bench-torch``;
6. checks that corrupted frames raise what
   ``lz4tpu_torch.decompress_host`` raises, under both verify modes;
   then soaks: ``SOAK_ROUNDS`` seeded rounds of
   ``lz4tpu_torch.exp.soak`` from ``SOAK_SEED`` (random payloads and
   frame options, a flipped byte and a truncation each, through every
   device entry point against the host engine, no host fallback on a
   frame the host decodes), requiring every decode kernel launched and
   every engine planned;
7. times the device content checksum against a fetch and the native
   host hash, size by size (why the port has no small-fetch branch);
8. prints one JSON line with every kernel, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits nonzero before the last line.  Without CUDA, or
outside a checkout of the repository, it exits nonzero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import re
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
    "mxu2_route_ab": ("lz4tpu_torch/csrc/mxu2_ab.cu", "exp/ab.py:34"),
    "emit_levels": ("lz4tpu_torch/csrc/emit_levels.cu",
                    "lz4tpu/device/encode.py:367"),
    # no TPU kernel: the host packer moved onto the card
    "dense_codes": ("lz4tpu_torch/csrc/dense_codes.cu",
                    "lz4tpu/device/mxu2.py:71"),
}
ENGINE_KERNELS = {"fused": ("fused_expand", "fused_route"),
                  "dense": ("mxu2_route", "dense_codes")}
SERVED = ("z9m", "b3.5m", "frag1m", "src1m", "frag32m", "frag32m-indep",
          "frag2m-bsum", "frag2m-legacy")


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
// One warp's dependent shared-memory round trip: each lane loads a word
// that another lane stored in the round before (its address comes from the
// last loaded value), stores its own, and the warp synchronises.  The time
// per round is the least a chain of matches that each read what the one
// before wrote can take per step on this card: segment_decode's chain
// bound.
__global__ void smem_probe(long long n_rounds, unsigned* state) {
  __shared__ unsigned buf[64];
  const unsigned lane = threadIdx.x;
  buf[lane] = state[lane];
  buf[32 + lane] = 0;
  __syncwarp();
  unsigned x = lane, h = 0;
#pragma unroll 4
  for (long long i = 0; i < n_rounds; ++i) {
    const unsigned v = buf[h * 32 + x];
    h ^= 1u;
    buf[h * 32 + lane] = v + 1u;
    __syncwarp();
    x = (v + 1u) & 31u;
  }
  state[lane] = x;
}
extern "C" int smem_probe_launch(long long n_rounds, void* state,
                                 void* stream) {
  smem_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      n_rounds, static_cast<unsigned*>(state));
  return int(cudaGetLastError());
}
"""


# The soak phase's rounds: seeds SOAK_SEED .. SOAK_SEED + SOAK_ROUNDS - 1.
# Fixed before the phase first ran on the card; a fault a seed finds is
# repaired, never stepped around by another seed or count.
SOAK_SEED = 7_000_000
SOAK_ROUNDS = 160


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
    skip = {"build", "_build", "__pycache__", "_checkout", "chiprun_out"}
    files = sorted(
        p for p in HERE.rglob("*")
        if p.suffix in (".py", ".cpp") and p.is_file()
        and not any(part.startswith(".") or part in skip
                    for part in p.relative_to(HERE).parts))
    blob = b"".join(p.read_bytes() for p in files)
    need(len(blob) >= n, f"repo text is {len(blob)} bytes, need {n}")
    return blob[:n]


def words32m(np, lt):
    """32 MiB of word tokens of the checkout's own text: the sorted
    unique tokens (words, runs of punctuation, runs of white space) of
    :func:`repo_text`'s first MiB, drawn uniformly with seed 15, as
    ``(compressed, original)``.  It plans as one dense (mxu2) chain of
    16,384 substeps: kernel H3 at a text chain's full part size.  Not
    served: the kernel phase and one ``decompress_to_device`` use it."""
    toks = sorted(set(re.findall(
        rb"[A-Za-z_][A-Za-z0-9_]*|[^A-Za-z0-9_\s]+|\s+", repo_text(1 << 20))))
    n = 32 << 20
    rng = np.random.default_rng(15)
    mean = np.mean([len(t) for t in toks])
    out = b"".join([toks[i] for i in rng.integers(0, len(toks),
                                                 int(n / mean * 1.1) + 16)])
    need(len(out) >= n, "word corpus came out short")
    return lt.compress(out[:n]), out[:n]


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


def segment_shapes(np, lt, corp):
    """What kernel H6 is timed on, as ``(name, compressed, original)``:
    frag1m (one chain), indep2m (2 MiB of fragments, seed 14, in 32
    independent 64 KiB blocks), frag32m in 512 independent 64 KiB
    blocks, and src1m (one chain) last."""
    kw = dict(block_max_code=4, block_independence=True)
    return (("frag1m", *corp["frag1m"][:2]),
            ("indep2m", *indep2m(np, lt)),
            ("frag32m in independent 64 KiB blocks",
             lt.compress(corp["frag32m"][1], **kw), corp["frag32m"][1]),
            ("src1m", *corp["src1m"][:2]))


def indep2m(np, lt):
    """2 MiB of fragments (seed 14) in 32 independent 64 KiB blocks, as
    ``(compressed, original)``: H6's shape under engine="pallas"."""
    indep = frag_text(np, 2 << 20, 8192, 3, 8, 14)
    return lt.compress(indep, block_max_code=4,
                       block_independence=True), indep


def expand_shapes(np, lt, tpl, corp):
    """What H1's expand is timed on, as ``(name, prep, n_sub)``: the
    first substeps of a prep, one launch's worth: frag1m's whole chain
    (556) and frag32m's first part (``PART_SUBS`` = 8192)."""
    from lz4tpu_torch.device import fused as fu

    p1 = plan_of(np, lt, tpl, corp["frag1m"][0])[3].fused_prep
    p32 = plan_of(np, lt, tpl, corp["frag32m"][0])[3].fused_prep
    return ((f"frag1m, {p1.n_sub} substeps", p1, p1.n_sub),
            (f"frag32m's first part, {fu.PART_SUBS} substeps", p32,
             fu.PART_SUBS))


def fill_shapes(np, lt, tpl, corp):
    """What H2 is timed on, as ``(name, vals)``: z9m's block-fill plan
    (18 blocks of 512 KiB, the main path's launch) and 256 blocks
    (128 MiB) of seeded int32 values with their high bits set."""
    from lz4tpu_torch.device import sparse_decode as sp

    prog = plan_of(np, lt, tpl, corp["z9m"][0])[3].sparse[0][1]
    fill = sp._plan_block_fill(prog.ops, prog.n_out)
    need(fill is not None, "z9m did not plan a block fill")
    wide = np.random.default_rng(17).integers(
        -2**31, 2**31 - 1, 256, dtype=np.int64).astype(np.int32)
    return ((f"z9m, {fill[0].size} blocks of 512 KiB",
             np.ascontiguousarray(fill[0].reshape(-1))),
            ("256 blocks of 512 KiB", wide))


def route_shapes(np, lt, tpl, corp, words):
    """What H3 is timed on, as ``(name, pack)`` with host codes: src1m
    (one dense chain of 512 substeps) and words32m (one of 16,384)."""
    return [(name, pack.packed())
            for name, pack in dense_shapes(np, lt, tpl, corp, words)]


def dense_shapes(np, lt, tpl, corp, words):
    """src1m's and words32m's packs as the planner leaves them, deferred
    (H9 builds their codes), as ``(name, pack)``.  Each pack reads its
    table's pooled columns: use it before the next scan on this thread."""
    for name, data in (("src1m", corp["src1m"][0]), ("words32m", words[0])):
        plan = plan_of(np, lt, tpl, data)[3]
        need(plan.dense_pack is not None and len(plan.dense_chains) == 1,
             f"{name} did not plan as one mxu2 chain")
        yield f"{name}, {plan.dense_pack.n_sub} substeps", plan.dense_pack


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def lineitem_pack(np, lt, tpl, n=96 << 20, seed=2**31 + 41):
    """The planner's deferred mxu2 pack of ``n`` bytes of TPC-H lineitem
    record batches, one frame a buffer at the ``arrow-lz4frame``
    configuration's flags (``lz4bench``'s corpus and frozen encoder, the
    ``tpch-lineitem-1m`` cell's inputs cut to ``n``): over a hundred
    chains, each ending mid-substep, more than ``mxu2.PART_SUBS``
    substeps in all.  The pack reads its table's pooled columns: use it
    before the next scan on this thread."""
    import concurrent.futures
    import json

    from lz4bench import encoder, harness

    config = json.loads((HERE / "lz4bench/configs/arrow-lz4frame.json")
                        .read_text())
    entry = harness._load_file(harness.HERE / "entries" / "decode_frames.py",
                               "entry")
    raw = harness.corpus("tpch_lineitem").make(
        n, harness.generator(seed, "tpch_lineitem", 0))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        data = b"".join(pool.map(
            lambda b: encoder.compress_frame(b, config["frame"],
                                             config["level"], workers=1),
            entry.split(raw)))
    plan = plan_of(np, lt, tpl, data)[3]
    return plan.dense_pack, len(plan.dense_chains)


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
    """The probes as ``{"xxh32": probe(n_rounds), "smem": ...}``, once
    their build has ended."""
    import ctypes

    log = proc.communicate()[0]
    need(proc.returncode == 0, f"nvcc failed on the chain probe:\n{log}")
    lib = ctypes.CDLL(str(so))
    state = torch.arange(1, 33, dtype=torch.int32, device="cuda")

    def bind(entry):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]

        def probe(n_rounds):
            status = fn(n_rounds, state.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
            need(status == 0, f"{entry} failed ({status})")
        return probe
    return {"xxh32": bind("chain_probe_launch"),
            "smem": bind("smem_probe_launch")}


def chain_depth(np, cols) -> int:
    """Depth of a chain's byte-level match dependency: a literal byte
    has depth 0, a match's bytes 1 + the largest depth in its source.
    No decoder can resolve the chain in fewer dependent steps."""
    dst, _src, lit_len, match_off, match_len = (c.tolist() for c in cols)
    depth = np.zeros(max(d + a + b for d, a, b in
                         zip(dst, lit_len, match_len)), np.uint32)
    for d, ll, off, ml in zip(dst, lit_len, match_off, match_len):
        if ml:
            md = d + ll
            lo = md - max(off, 1)
            depth[md:md + ml] = 1 + int(depth[lo:min(lo + ml, md)].max())
    return int(depth.max())


def fill_library(torch, vals, blk):
    """One PyTorch call computing the block fill: a copy of an expanded
    view (timed beside kernel H2; the port never calls it)."""
    return ((vals & 255).to(torch.uint8)[:, None]
            .expand(vals.shape[0], blk).contiguous().reshape(-1))


def kernel_name(mangled: str) -> str:
    """The ``..._kernel`` source name inside a mangled entry name (a
    mangled name holds each source name behind that name's length)."""
    at = mangled.find("_kernel")
    end = at + len("_kernel")
    for start in range(end - 1 if at >= 0 else 0, 0, -1):
        name = mangled[start:end]
        if name[0].isalpha() and mangled[:start].endswith(str(len(name))):
            return name
    return mangled[:60]


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

def kernel_phase(torch, np, lt, tpl, corp, words, dev, name_card, probe):
    """Each kernel against its plain version, timed, with its bound."""
    from lz4tpu_torch import native
    from lz4tpu_torch.device import fused as fu
    from lz4tpu_torch.device import mxu2 as mx
    from lz4tpu_torch.device import segment_decode as sg
    from lz4tpu_torch.device import sparse_decode as sp
    from lz4tpu_torch.device import to_device
    from lz4tpu_torch.device import xxh32_cuda as xx
    from lz4tpu_torch.device.ring import part_segments, segments_tensor
    from lz4tpu_torch.exp import ab, edge

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
    # H1's expand at each launch shape it has on the paths: frag1m's
    # chain, frag32m's first part; frag1m's is the row's
    by_shape, err = {}, 0
    for name, prep_e, n_e in expand_shapes(np, lt, tpl, corp):
        te = [to_device(np.ascontiguousarray(getattr(prep_e, k)[:n_e]), dev)
              for k in ("seqrec", "scal", "patch")]
        got = fu.expand(*te)
        err_e = max_abs_err(torch, got, fu.expand_plain(*te))
        need(err_e <= TOL, f"fused_expand: {name} differs from plain "
                           f"(max abs err {err_e})")
        err = max(err, err_e)
        by_shape[name] = {
            "ms": cuda_ms(torch, lambda: fu.expand(*te), 20),
            "plain_ms": cuda_ms(torch, lambda: fu.expand_plain(*te), 5),
            "bound_ms": 1e3 * nbytes(*te, got) / HBM_BYTES_PER_S}
        print(f"[kernel] fused_expand: equal to plain at {name}: kernel "
              f"{by_shape[name]['ms']:.4f} ms, bound "
              f"{by_shape[name]['bound_ms']:.4f} ms (bytes), plain "
              f"{by_shape[name]['plain_ms']:.4f} ms [{name_card}]",
              flush=True)
        del te, got
    main_e = by_shape[shape]
    record("fused_expand", err, main_e["ms"], main_e["plain_ms"],
           main_e["bound_ms"], "bytes", shape)
    rows["fused_expand"]["by_shape"] = by_shape
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
    # the route at the edges of its gather (sources across a word, a
    # run's end, the ring's end into the window), one and three segments,
    # zero and seeded ring, and a ring carried from launch to launch
    case = edge.route_case(n_sub=300)    # passes the scalar chunks twice
    e_pos, e_lits, e_winq, e_scal = (to_device(a, dev) for a in case)
    n_e = case[0].shape[0]
    seed_ring = to_device(np.random.default_rng(9).integers(
        0, 256, 65536, dtype=np.uint8), dev)
    for segs_e in ([(0, n_e, 0)], [(0, n_e, 1)],
                   [(0, 1, 1), (1, 3, 0), (3, n_e, 0)]):
        st = segments_tensor(segs_e, dev)
        got = fu.route(e_pos, e_lits, e_winq, e_scal, st, seed_ring)
        want = fu.route_plain(e_pos, e_lits, e_winq, e_scal, st, seed_ring)
        torch.cuda.synchronize()
        need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
             f"fused_route: edge sources, segments {segs_e}: kernel differs "
             "from plain")
    # sources outside the 17-bit space clamp as the plain version's do
    stray = [to_device(a, dev) for a in edge.route_case(n_sub=20, stray=True)]
    st = segments_tensor([(0, 20, 1)], dev)
    got = fu.route(*stray, st, seed_ring)
    want = fu.route_plain(*stray, st, seed_ring)
    torch.cuda.synchronize()
    need(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
         "fused_route: sources below 0 and past the window: kernel differs "
         "from plain")
    whole = fu.route(e_pos, e_lits, e_winq, e_scal,
                     segments_tensor([(0, n_e, 0)], dev))
    for cut in (1, 3, 17, 130):
        first = fu.route(e_pos[:cut], e_lits, e_winq[:cut], e_scal[:cut],
                         segments_tensor([(0, cut, 0)], dev))
        second = fu.route(e_pos[cut:], e_lits, e_winq[cut:], e_scal[cut:],
                          segments_tensor([(0, n_e - cut, 1)], dev), first[1])
        torch.cuda.synchronize()
        need(torch.equal(torch.cat([first[0], second[0]]), whole[0])
             and torch.equal(second[1], whole[1]),
             f"fused_route: ring carried across launches at substep {cut} "
             "differs from one launch")
    print(f"[kernel] fused_route: equal to plain on {n_e} substeps of edge "
          "sources (word, run end, ring end), 1 and 3 segments, seeded ring, "
          "ring carried across launches, and on sources outside the 17-bit "
          "space", flush=True)

    # H3 on src1m (one mxu2 chain, 512 substeps) and words32m (16,384):
    # against the serial plain route and the original bytes; the plain
    # route is timed on src1m only
    by_shape, err = {}, 0
    for name, pack in route_shapes(np, lt, tpl, corp, words):
        code, scal = to_device(pack.code, dev), to_device(pack.scal, dev)
        segs = segments_tensor(part_segments(pack.out_spans, 0, pack.n_sub,
                                             False), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got, ring_g = mx._route(code, scal, segs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        want, ring_w = mx.route_plain(code, scal, segs)
        torch.cuda.synchronize()
        need(torch.equal(ring_g, ring_w), f"mxu2_route: {name}: ring_out "
                                          "differs from plain")
        blob = words[1] if name.startswith("words") else corp["src1m"][1]
        need(got[:len(blob)].cpu().numpy().tobytes() == blob,
             f"mxu2_route: {name} differs from the original")
        err = max(err, max_abs_err(torch, got, want))
        by_shape[name] = {
            "ms": cuda_ms(torch, lambda: mx._route(code, scal, segs), 20),
            "bound_ms": 1e3 * nbytes(code, scal, segs, got, ring_g)
            / HBM_BYTES_PER_S, "peak_bytes": peak}
        if name.startswith("src1m"):
            by_shape[name]["plain_ms"] = cuda_ms(
                torch, lambda: mx.route_plain(code, scal, segs), 2)
            src_shape, out_k = name, got
        print(f"[kernel] mxu2_route: equal to plain and to the original at "
              f"{name}: kernel {by_shape[name]['ms']:.4f} ms, bound "
              f"{by_shape[name]['bound_ms']:.4f} ms (bytes), "
              f"{mx.passes_for(pack.n_sub)} passes at most; peak device "
              f"memory of the call {peak} B beside a code array of "
              f"{code.numel() * 4} B [{name_card}]", flush=True)
        del code, got, want
    main_r = by_shape[src_shape]
    record("mxu2_route", err, main_r["ms"], main_r["plain_ms"],
           main_r["bound_ms"], "bytes", src_shape)
    rows["mxu2_route"]["by_shape"] = by_shape
    # a pack of 16 independent chains, a seeded ring, and the ring carried
    # from part to part
    data, blob = corp["src1m"][0], corp["src1m"][1]
    multi = plan_of(np, lt, tpl, lt.compress(
        blob, block_independence=True, block_max_code=4))[3]
    need(len(multi.dense_chains) == 16, "src1m in independent 64 KiB "
         f"blocks planned {len(multi.dense_chains)} mxu2 chains, not 16")
    pack = multi.dense_pack
    seed_ring = to_device(np.random.default_rng(13).integers(
        0, 256, 65536, dtype=np.uint8), dev)
    for ring_in, part in ((None, None), (seed_ring, None), (None, 37),
                          (seed_ring, 37)):
        got = mx.decode_dense2_rows(pack, dev, ring_in=ring_in,
                                    part_subs=part)
        want = mx.decode_dense2_rows(pack, "cpu", ring_in=None if ring_in
                                     is None else ring_in.cpu(),
                                     part_subs=part)
        torch.cuda.synchronize()
        need(torch.equal(got[0].cpu(), want[0])
             and torch.equal(got[1].cpu(), want[1]),
             f"mxu2_route: 16 chains, ring_in {ring_in is not None}, parts "
             f"of {part}: kernel differs from plain")
    print(f"[kernel] mxu2_route: equal to plain on 16 independent chains "
          f"({pack.n_sub} substeps), zero and seeded ring, one launch and "
          "parts of 37 substeps carrying the ring", flush=True)

    # H9 on the same two chains: against its plain version and the host
    # packer, and timed; bound: the columns read once, the codes written
    # once
    by_shape, err = {}, 0
    for name, pack in dense_shapes(np, lt, tpl, corp, words):
        n = pack.n_sub
        host = pack.packed().code
        staged = mx.stage_dense_codes(pack, dev)
        got = mx.dense_codes(*staged, 0, n)
        mx.raise_on_fault(staged[3])
        want = mx.dense_codes_plain(*staged[:3], 0, n)
        torch.cuda.synchronize()
        need(np.array_equal(got.cpu().numpy(), host),
             f"dense_codes: {name} differs from the host packer")
        err = max(err, max_abs_err(torch, got, want))
        by_shape[name] = {
            "ms": cuda_ms(torch, lambda: mx.dense_codes(*staged, 0, n),
                         20),
            "bound_ms": 1e3 * nbytes(staged[0], got) / HBM_BYTES_PER_S}
        if name.startswith("src1m"):
            by_shape[name]["plain_ms"] = cuda_ms(
                torch, lambda: mx.dense_codes_plain(*staged[:3], 0, n), 2)
            src_shape = name
        print(f"[kernel] dense_codes: equal to plain and to the host packer "
              f"at {name}: kernel {by_shape[name]['ms']:.4f} ms, bound "
              f"{by_shape[name]['bound_ms']:.4f} ms (bytes: "
              f"{staged[0].shape[1]} sequences) [{name_card}]", flush=True)
        del staged, got, want, host
    # H9 on many chains in one launch: the tpch-lineitem-1m cell's
    # shape, parts of mxu2.PART_SUBS substeps whose blocks find their
    # chain among a hundred and more, chains that end mid-substep
    pack, n_chains = lineitem_pack(np, lt, tpl)
    need(n_chains > 100 and pack.n_sub > mx.PART_SUBS,
         f"lineitem planned {n_chains} mxu2 chains of {pack.n_sub} "
         f"substeps, not over 100 chains and {mx.PART_SUBS} substeps")
    host = pack.packed().code
    staged = mx.stage_dense_codes(pack, dev)
    for p0 in range(0, pack.n_sub, mx.PART_SUBS):
        n = min(mx.PART_SUBS, pack.n_sub - p0)
        got = mx.dense_codes(*staged, p0, n)
        want = mx.dense_codes_plain(*staged[:3], p0, n)
        mx.raise_on_fault(staged[3])
        err = max(err, max_abs_err(torch, got, want))
        need(np.array_equal(got.cpu().numpy(), host[p0:p0 + n]),
             f"dense_codes: lineitem part at {p0} differs from the host "
             "packer")
        if p0 == 0:
            name = f"lineitem, {n_chains} chains, a part of {n} substeps"
            by_shape[name] = {
                "ms": cuda_ms(torch, lambda: mx.dense_codes(*staged, 0, n),
                              20),
                "bound_ms": 1e3 * (nbytes(got) + nbytes(staged[0]) * n
                                   / pack.n_sub) / HBM_BYTES_PER_S}
        del got, want
    print(f"[kernel] dense_codes: equal to plain and to the host packer on "
          f"lineitem, {n_chains} chains, {pack.n_sub} substeps in parts of "
          f"{mx.PART_SUBS}: kernel {by_shape[name]['ms']:.4f} ms a part "
          f"[{name_card}]", flush=True)
    del staged, host, pack
    # H9's hand-made edges (exp/edge.DENSE_CASES), whole and in parts of
    # 3 substeps; before-chain stores the host packer's status 2
    for case in edge.DENSE_CASES:
        (out_start, ll, ls, ml, mo), buf, ranges = edge.dense_case(case)
        pack = mx.defer_dense2(out_start, ll, ml, mo, ls, buf, ranges)
        staged = mx.stage_dense_codes(pack, dev)
        if case == "before-chain":
            mx.dense_codes(*staged, 0, pack.n_sub)
            try:
                mx.raise_on_fault(staged[3])
            except ValueError as e:
                need(str(e) == "pack_dense2 failed with status 2",
                     f"dense_codes: before-chain raised {e!r}")
            else:
                need(False, "dense_codes: before-chain raised nothing")
            continue
        host = pack.packed().code
        for part in (pack.n_sub, 3):
            got = torch.cat([mx.dense_codes(*staged, p0,
                                            min(part, pack.n_sub - p0))
                             for p0 in range(0, pack.n_sub, part)])
            want = mx.dense_codes_plain(*staged[:3], 0, pack.n_sub)
            mx.raise_on_fault(staged[3])
            err = max(err, max_abs_err(torch, got, want))
            need(np.array_equal(got.cpu().numpy(), host),
                 f"dense_codes: edge {case}, parts of {part}, differs from "
                 "the host packer")
    print(f"[kernel] dense_codes: equal to plain and to the host packer on "
          f"the edges {', '.join(edge.DENSE_CASES)} (whole and in parts of "
          "3 substeps); before-chain raised the host packer's status 2",
          flush=True)
    main_c = by_shape[src_shape]
    record("dense_codes", err, main_c["ms"], main_c["plain_ms"],
           main_c["bound_ms"], "bytes", src_shape)
    rows["dense_codes"]["by_shape"] = by_shape

    # H7: every exact variant (the pointer-jumping decode, its graph, the
    # serial loop and its prefetch) at every substep size against plain
    # from a seeded ring, rows and ring_out: on 200 KB (the ring wraps
    # three times), on src1m, and on made-up codes whose first substeps
    # read the ring; then on src1m against the original bytes, and at
    # sub 2048 against H3's rows.  Timed on src1m, with the peak device
    # memory of a jump decode
    small = blob[:200_000]
    small_data = lt.compress(small)
    ring_in = to_device(np.random.default_rng(31).integers(
        0, 256, 65536, dtype=np.uint8), dev)
    err, by_sub = 0, {}
    for sub in ab.SUBS:
        cases = {"200 KB": to_device(ab.pack_host(small_data, sub)[0], dev),
                 "src1m": to_device(ab.pack_host(data, sub)[0], dev),
                 "made-up codes": to_device(edge.ab_codes(24, sub), dev)}
        plain = {name: ab.route_variant_plain(c, sub, ring_in)
                 for name, c in cases.items()}
        need(plain["200 KB"][0][:len(small)].cpu().numpy().tobytes()
             == small, f"route_variant_plain sub={sub}: 200 KB differ from "
                       "the original")
        code_f = cases["src1m"]
        n_sub = code_f.shape[0]
        by_sub[sub] = {"live_passes": ab.live_passes(code_f, sub)}
        for variant in ab.EXACT:
            for name, c in cases.items():
                rows_k, ring_k = ab.route_variant(c, sub, ring_in, variant)
                torch.cuda.synchronize()
                need(torch.equal(ring_k, plain[name][1]),
                     f"mxu2_route_ab sub={sub} {variant}: {name}: ring_out "
                     "differs from plain")
                e = max_abs_err(torch, rows_k, plain[name][0])
                need(e <= TOL, f"mxu2_route_ab sub={sub} {variant}: {name}:"
                               f" rows differ from plain (max abs err {e})")
                err = max(err, e)
            full, ring_f = ab.route_variant(code_f, sub, None, variant)
            torch.cuda.synchronize()
            need(full[:len(blob)].cpu().numpy().tobytes() == blob,
                 f"mxu2_route_ab sub={sub} {variant}: src1m differs from "
                 "the original")
            if sub == mx.SUB:
                need(torch.equal(full, out_k),
                     f"mxu2_route_ab sub=2048 {variant} differs from "
                     "mxu2_route")
            by_sub[sub][variant] = cuda_ms(torch, lambda: ab.route_variant(
                code_f, sub, None, variant), 20)
            if (sub, variant) == (mx.SUB, "exact"):
                ab_code, ab_out, ab_ring = code_f, full, ring_f
                ab_plain_ms = cuda_ms(
                    torch, lambda: ab.route_variant_plain(code_f, sub), 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ab.route_variant(code_f, sub)
        torch.cuda.synchronize()
        by_sub[sub]["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        r = by_sub[sub]
        print(f"[kernel] mxu2_route_ab sub={sub}: every exact variant equal "
              f"to plain on 200 KB, src1m and made-up codes from a seeded "
              f"ring; src1m, {n_sub} substeps: exact {r['exact']:.4f} "
              f"ms ({mx.passes_for(n_sub)} passes, {r['live_passes']} live), "
              f"graph "
              f"{r['graph']:.4f}, serial {r['serial']:.4f}, prefetch "
              f"{r['prefetch']:.4f}; peak device memory of an exact call "
              f"{r['peak_bytes']} B beside a code array of "
              f"{code_f.numel() * 4} B [{name_card}]", flush=True)
        del cases, plain, code_f, full
    record("mxu2_route_ab", err, by_sub[mx.SUB]["exact"], ab_plain_ms,
           1e3 * nbytes(ab_code, ab_out, ab_ring) / HBM_BYTES_PER_S,
           "bytes", f"src1m, {ab_code.shape[0]} substeps of {mx.SUB}, "
           "variant exact")
    rows["mxu2_route_ab"]["by_sub"] = by_sub

    # H2 on z9m (the block-fill plan's 18 blocks of 512 KiB) and on 256
    # blocks; the library call is one copy of an expanded view
    by_shape, err = {}, 0
    for name, v in fill_shapes(np, lt, tpl, corp):
        vals = to_device(v, dev)
        got_k = sp.block_fill(vals)
        got_p = sp.block_fill_plain(vals)
        got_l = fill_library(torch, vals, sp.FILL_BLK)
        torch.cuda.synchronize()
        need(torch.equal(got_l, got_p), f"block_fill: the library call "
                                        f"differs from plain at {name}")
        err = max(err, max_abs_err(torch, got_k, got_p))
        by_shape[name] = {
            "ms": cuda_ms(torch, lambda: sp.block_fill(vals), 50),
            "plain_ms": cuda_ms(torch, lambda: sp.block_fill_plain(vals), 50),
            "library_ms": cuda_ms(
                torch, lambda: fill_library(torch, vals, sp.FILL_BLK), 50),
            "bound_ms": 1e3 * nbytes(vals, got_k) / HBM_BYTES_PER_S}
        print(f"[kernel] block_fill at {name}: kernel "
              f"{by_shape[name]['ms']:.4f} ms, library call (expanded "
              f"copy) {by_shape[name]['library_ms']:.4f} ms, bound "
              f"{by_shape[name]['bound_ms']:.4f} ms (bytes), plain "
              f"{by_shape[name]['plain_ms']:.4f} ms [{name_card}]",
              flush=True)
        del got_k, got_p, got_l
    main_f = next(iter(by_shape.values()))
    record("block_fill", err, main_f["ms"], main_f["plain_ms"],
           main_f["bound_ms"], "bytes", next(iter(by_shape)),
           library_ms=main_f["library_ms"])
    rows["block_fill"]["by_shape"] = by_shape

    # the xxh32 chain alone: time per round of the dependent lane update
    rounds = 4_000_000
    round_ns = 1e6 * cuda_ms(
        torch, lambda: probe["xxh32"](rounds), 5) / rounds
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

    # H6: small shape and the edge tables against plain, then src1m and
    # frag1m (one chain each), 32 and 512 independent chains against the
    # original bytes; the chain bound from the table's dependency depth
    def tables(data):
        buf, parsed, table, _plan, _st = plan_of(np, lt, tpl, data)
        chains = [c for c in tpl._chains_of(table) if c.out_hi > c.out_lo]
        cols, rws = tpl._segment_tables(parsed, table, chains)
        comp = to_device(buf, dev)
        need(sg.covers(cols, rws), "an LZ4 table leaves output unwritten")
        seqs, ch, total, longest = sg.pack_chains(cols, rws, comp.shape[0],
                                                  dev)
        return comp, seqs, ch, total, cols, longest

    small_text = repo_text(1 << 16)
    comp, seqs, ch, total, _c, longest = tables(lt.compress(small_text))
    sm_k = sg.segment_decode(comp, seqs, ch, total, zero_fill=False,
                             max_chain=longest)
    sm_p = sg.segment_decode_plain(comp, seqs, ch, total)
    torch.cuda.synchronize()
    err = max_abs_err(torch, sm_k, sm_p)
    need(sm_k.cpu().numpy().tobytes() == small_text,
         "segment_decode: 64 KiB text differs from the original")
    plain_ms = cuda_ms(
        torch, lambda: sg.segment_decode_plain(comp, seqs, ch, total), 1)
    plain_shape = f"64 KiB of src text, {seqs.shape[1]} sequences"
    for name in edge.SEGMENT_CASES:
        e_comp, e_cols, e_n, e_want = edge.segment_case(name)
        e_dev = to_device(e_comp, dev)
        e_seqs, e_ch, e_total, e_longest = sg.pack_chains(
            [e_cols], [(e_cols[0].size, 0, 0, e_n)], e_comp.size, dev)
        for ring_hint in (e_longest, None):
            got = sg.segment_decode(e_dev, e_seqs, e_ch, e_total,
                                    max_chain=ring_hint)
            torch.cuda.synchronize()
            need(np.array_equal(got.cpu().numpy(), e_want),
                 f"segment_decode: edge table {name} differs from its "
                 "reference")
        err = max(err, max_abs_err(
            torch, got, sg.segment_decode_plain(e_dev, e_seqs, e_ch,
                                                e_total)))
    print(f"[kernel] segment_decode: equal to plain and to the numpy "
          f"reference on the edge tables {', '.join(edge.SEGMENT_CASES)} "
          "(a chain beyond the ring with offset 65,535, gaps and overlapping "
          "matches across tile edges, offsets above 65,535)", flush=True)
    rounds = 2_000_000
    trip_ns = 1e6 * cuda_ms(torch, lambda: probe["smem"](rounds), 5) / rounds
    print(f"[kernel] shared-memory round trip probe: {trip_ns:.3f} ns per "
          f"dependent load, store and warp synchronisation (one warp, "
          f"{rounds} rounds) [{name_card}]", flush=True)
    for name, data, blob in segment_shapes(np, lt, corp):
        comp, seqs, ch, total, cols, longest = tables(data)
        got = sg.segment_decode(comp, seqs, ch, total, zero_fill=False,
                                max_chain=longest)
        torch.cuda.synchronize()
        need(got.cpu().numpy().tobytes() == blob,
             f"segment_decode: {name} differs from the original")
        ms = cuda_ms(torch, lambda: sg.segment_decode(
            comp, seqs, ch, total, zero_fill=False, max_chain=longest), 5)
        lit_bytes = sum(int(c[2].sum()) for c in cols)
        bound = 1e3 * (lit_bytes + nbytes(seqs, ch) + total) / HBM_BYTES_PER_S
        shape = (f"{name}, {ch.shape[0]} chain(s), {seqs.shape[1]} "
                 "sequences")
        line = (f"[kernel] segment_decode: {ms:.4f} ms at {shape}, ring "
                f"{sg.ring_bytes_for(longest)} B, bound {bound:.4f} ms "
                "(bytes)")
        if ch.shape[0] == 1:
            depth = chain_depth(np, cols[0])
            chain_ms = depth * trip_ns * 1e-6
            line += (f", chain depth {depth}, {seqs.shape[1] / depth:.2f} "
                     f"sequences per step, chain bound {chain_ms:.4f} ms "
                     f"(depth x {trip_ns:.3f} ns)")
        print(f"{line} [{name_card}]", flush=True)
    need(ch.shape[0] == 1, "src1m is not one chain")
    record("segment_decode", err, ms, plain_ms, bound, "bytes", shape,
           plain_shape=plain_shape)
    rows["segment_decode"]["chain_ms"] = chain_ms

    # H8 on the encode cell's block: words32m's first 4 MiB and 64 KiB
    from lz4tpu_torch.device import emit_levels as el
    from lz4tpu_torch.device import encode as enc

    buf, _n, n_pad = enc._pad(np.frombuffer(words[1][:BLOCK + HISTORY],
                                            np.uint8), dev)
    g = enc._gram_words(buf)
    order = enc._sort_order(g)
    p_s = order.to(torch.int32)
    ws = [w.gather(-1, order) for w in g]
    got, want = el.emit_levels(buf, p_s), enc._level_deltas(ws, p_s)
    torch.cuda.synchronize()
    # bytes: the block and the positions read once, 8 int32 a position out
    record("emit_levels", max(max_abs_err(torch, got[k], want[k])
                              for k in want),
           cuda_ms(torch, lambda: el.emit_levels(buf, p_s), 20),
           cuda_ms(torch, lambda: enc._level_deltas(ws, p_s), 3),
           1e3 * (n_pad + 4 * n_pad + 32 * n_pad) / HBM_BYTES_PER_S,
           "bytes", f"words32m's first block, n_pad {n_pad}")
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
                   mode, extra=None):
    """decompress_to_device(verify=mode) over the corpora and ``extra``
    (more of the same shape); returns the launch counts of this path."""
    _kernels.reset_launches()
    total = dict.fromkeys(_kernels.LAUNCHES, 0)
    for name, (data, blob, engines, fills, bsums) in {**corp,
                                                      **(extra or {})}.items():
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
        ms = in_turns(torch, {
            mode: (lambda m=mode: lt.decompress_to_device(
                data, device="cuda", verify=m))
            for mode in ("host", "device")}, pairs)
        print(f"[verify] {name}: " + " against ".join(
            f"verify={mode!r} {med_range(t)}" for mode, t in ms.items())
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
    for name, data, blob in segment_shapes(np, lt, corp):
        if name.startswith("frag32m"):
            continue            # 512 chains: the kernel phase's shape
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


def ab_path(torch, lt, _kernels, corp, name_card):
    """The A/B harness of the mxu2 route variants (kernel H7), short
    setting: the pointer-jumping decode, its graph and the serial loop
    at every substep size, and every ablation, on src1m."""
    from lz4tpu_torch.exp import ab

    _kernels.reset_launches()
    data, blob = corp["src1m"][0], corp["src1m"][1]
    lo, hi, rounds = 4, 16, 3
    results = ab.run(data, blob, ab.DEFAULT_SPECS, lo=lo, hi=hi,
                     rounds=rounds)
    need(len(results) == len(ab.DEFAULT_SPECS)
         and {r["sub"] for r in results if r["exact"]} == set(ab.SUBS),
         "the harness did not time every exact substep size")
    need({r["variant"] for r in results} == set(ab.VARIANTS),
         "the harness did not time every variant")
    for r in results:
        need(r["ms"] > 0, f"[ab] {r['name']}: no time measured")
        print(f"[ab] {ab.format_row(r)} (chains of {lo} and {hi}, median "
              f"of {rounds} rounds) [{name_card}]", flush=True)
    return dict(_kernels.LAUNCHES)


def in_turns(torch, fns, pairs=5):
    """Host-clock ms of each fn() ended by a synchronise, in turns (the
    order alternates pair by pair): name -> list."""
    ms = {k: [] for k in fns}
    names = list(fns)
    for i in range(pairs):
        for k in (names, names[::-1])[i % 2]:
            s = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            ms[k].append(1e3 * (time.perf_counter() - s))
    return ms


def med_range(t) -> str:
    return f"{statistics.median(t):.3f} ms ({min(t):.3f}..{max(t):.3f})"


def windowed(session, datas, collect, window=4):
    """Submit ``datas`` with at most ``window`` tickets uncollected,
    collecting the oldest first; returns collect(ticket) per input."""
    tickets, outs = [], []
    for data in datas:
        while len(tickets) >= window:
            outs.append(collect(tickets.pop(0)))
        tickets.append(session.submit(data))
    outs.extend(collect(t) for t in tickets)
    return outs


def session_path(torch, lt, tpl, _kernels, corp, dev, name_card):
    """One DecodeSession(max_inflight=4) answers every corpus by
    result(), result_on_device(verify="device") and
    result_on_device(verify="none") followed by result(); corrupted
    frames raise on their own tickets; submit blocks at the bound."""
    import threading

    datas = [corp[n][0] for n in SERVED]
    blobs = [corp[n][1] for n in SERVED]
    # corrupted frames, and what the batch stages raise for each: taken
    # before the counts are set to 0, so that the session's counts hold
    # only what the session launched
    block = bytearray(corp["frag2m-bsum"][0])
    block[300] ^= 0x20
    content = bytearray(corp["frag1m"][0])
    content[-1] ^= 0x01
    bad = {"corrupted block": bytes(block),
           "flipped content checksum": bytes(content)}
    wants = {}
    for what, data in bad.items():
        for mode in ("host", "device"):
            try:
                tpl._decompress_to_device_batch(data, lt.FOR_ALL, dev, mode)
            except lt.Lz4Error as e:
                wants[what, mode] = e
            else:
                raise SmokeFailure(f"the batch stages decoded the {what}")
    torch.cuda.synchronize()
    _kernels.reset_launches()

    def same(outs, what):
        for name, out, blob in zip(SERVED, outs, blobs):
            if not isinstance(out, bytes):
                need(out.is_cuda and out.dtype == torch.uint8,
                     f"{name}: {what} is not a CUDA uint8 tensor")
                out = out.cpu().numpy().tobytes()
            need(out == blob, f"{name}: session {what} differs from the "
                              "original")

    with lt.DecodeSession(max_inflight=4) as s:
        need(s.device.type == "cuda", "the session did not take the card")
        t0 = time.perf_counter()
        deferred = []

        def none_then_bytes(t):
            deferred.append(t.result_on_device(verify="none"))
            return t.result()

        with host_decode_refused():
            same(windowed(s, datas, lambda t: t.result()), "result()")
            same(windowed(s, datas, lambda t: t.result_on_device(
                verify="device")), "result_on_device(verify='device')")
            same(windowed(s, datas, none_then_bytes),
                 "result() after result_on_device(verify='none')")
            same(deferred, "result_on_device(verify='none')")
        del deferred
        torch.cuda.synchronize()
        print(f"[session] {len(SERVED)} corpora x 3 rounds (result, "
              "result_on_device verify='device', verify='none' then "
              f"result) in {time.perf_counter() - t0:.3f} s, original "
              f"bytes every time [{name_card}]", flush=True)

        # corrupted frames between good ones: each raises on its own
        # ticket what the batch stages raise; the neighbours answer
        for collect, mode in (("result", "host"),
                              ("result_on_device", "device")):
            tickets = [s.submit(corp["frag1m"][0]),
                       s.submit(bad["corrupted block"]),
                       s.submit(bad["flipped content checksum"]),
                       s.submit(corp["src1m"][0])]
            for what, t in zip(bad, tickets[1:3]):
                want = wants[what, mode]
                try:
                    getattr(t, collect)()
                except lt.Lz4Error as e:
                    got = e
                else:
                    raise SmokeFailure(f"session {collect}() decoded the "
                                       f"{what}")
                need(type(got) is type(want) and str(got) == str(want),
                     f"session error parity ({what}, {collect}): "
                     f"{type(got).__name__}({got}) vs "
                     f"{type(want).__name__}({want})")
                print(f"[session] {what} via {collect}(): "
                      f"{type(got).__name__}: {got} (as the batch stages "
                      f"under verify={mode!r})", flush=True)
            need(tickets[0].result() == corp["frag1m"][1]
                 and tickets[3].result() == corp["src1m"][1],
                 "a corrupted frame poisoned its neighbours' tickets")
        # verify="none" hands the bytes out unverified; the result()
        # that follows settles the checksum and raises
        t = s.submit(bad["flipped content checksum"])
        arr = t.result_on_device(verify="none")
        need(arr.cpu().numpy().tobytes() == corp["frag1m"][1],
             "verify='none' did not deliver the decoded bytes")
        try:
            t.result()
        except lt.ChecksumError as e:
            print("[session] flipped content checksum via "
                  "result_on_device(verify='none') then result(): bytes "
                  f"delivered, then ChecksumError: {e}", flush=True)
        else:
            raise SmokeFailure("result() after verify='none' did not "
                               "verify the content checksum")

        # submit blocks at the fifth uncollected ticket
        held = [s.submit(corp["frag1m"][0]) for _ in range(4)]
        state = {}

        def fifth():
            state["ticket"] = s.submit(corp["frag1m"][0])

        th = threading.Thread(target=fifth, daemon=True)
        th.start()
        th.join(timeout=1.0)
        need(th.is_alive() and "ticket" not in state,
             "submit did not block at the fifth uncollected ticket")
        need(held[0].result() == corp["frag1m"][1], "held ticket differs")
        th.join(timeout=60)
        need(not th.is_alive() and "ticket" in state,
             "submit stayed blocked after a ticket was collected")
        for t in held[1:] + [state["ticket"]]:
            need(t.result() == corp["frag1m"][1], "held ticket differs")
        print("[session] submit blocked at the fifth uncollected ticket and "
              "went on after one was collected", flush=True)
    need(not any(th.name == "lz4tpu-prep" for th in threading.enumerate()),
         "the session's prep thread did not stop")
    counts = dict(_kernels.LAUNCHES)
    for k in ("fused_expand", "fused_route", "mxu2_route", "block_fill",
              "xxh32_stream", "dense_codes"):
        need(counts[k] > 0, f"session: kernel {k} was not launched")
    # the session hashes block checksums on the host and decodes by plan
    for k in ("xxh32_blocks", "segment_decode", "mxu2_route_ab"):
        need(counts[k] == 0, f"session: kernel {k} was counted "
                             f"{counts[k]} times; the session never "
                             "launches it")
    return counts


def sustained_phase(torch, np, lt, tpl, corp, name_card, pairs=5):
    """The corpus list through one session with four in flight against a
    serial loop of decompress_to_device, both verify="none", in turns;
    and the serial host-stage rate (parse + scan + plan) beside them."""
    datas = [corp[n][0] for n in SERVED]
    total = sum(len(corp[n][1]) for n in SERVED)

    def host_stages():
        for data in datas:
            buf = np.frombuffer(data, np.uint8)
            parsed = tpl.parse_frames(buf, lt.FOR_ALL)
            table = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data,
                                        pooled_cols=True)
            tpl.plan_decode(buf, parsed, table)

    def serial():
        for data in datas:
            lt.decompress_to_device(data, verify="none")

    with lt.DecodeSession(max_inflight=4) as s:
        def session():
            windowed(s, datas,
                     lambda t: t.result_on_device(verify="none"))

        session()
        serial()
        host_stages()
        torch.cuda.synchronize()
        ms = in_turns(torch, {"session": session, "serial": serial,
                              "host_stages": host_stages}, pairs)
    for k, what in (("session", "DecodeSession(max_inflight=4), "
                                "result_on_device(verify='none')"),
                    ("serial", "serial loop of decompress_to_device("
                               "verify='none')"),
                    ("host_stages", "serial host stages alone (parse + "
                                    "scan + plan)")):
        med = statistics.median(ms[k])
        print(f"[sustained] {what}: {med_range(ms[k])} per round of "
              f"{len(datas)} corpora, {total} B decoded = "
              f"{total / med / 1e6:.3f} GB/s (median and range of {pairs}, "
              f"in turns) [{name_card}]", flush=True)


def staging_phase(torch, np, dev, name_card):
    """Pinned staging (device.to_device) against the pageable copy, by
    size: host time until the call returns, and until the copy is done."""
    from lz4tpu_torch.device import to_device

    rng = np.random.default_rng(41)
    for n in (12, 2048, 1 << 16, 1 << 20, 4 << 20, 64 << 20):
        a = rng.integers(0, 256, n, dtype=np.uint8)
        got = to_device(a, dev)
        torch.cuda.synchronize()
        need(got.is_cuda and np.array_equal(got.cpu().numpy(), a),
             f"to_device: {n} bytes differ after staging")
        times = {"pinned": ([], []), "pageable": ([], [])}
        for i in range(7):
            for k in (("pinned", "pageable"), ("pageable", "pinned"))[i % 2]:
                torch.cuda.synchronize()
                s = time.perf_counter()
                if k == "pinned":
                    t = to_device(a, dev)
                else:
                    t = torch.from_numpy(a).to(dev)
                mid = time.perf_counter()
                torch.cuda.synchronize()
                end = time.perf_counter()
                times[k][0].append(1e3 * (mid - s))
                times[k][1].append(1e3 * (end - s))
                del t
        print(f"[staging] {n} B: " + ", ".join(
            f"{k} returns after {statistics.median(r):.4f} ms, done after "
            f"{statistics.median(d):.4f} ms" for k, (r, d) in times.items())
            + f" (host clock, median of 7, in turns) [{name_card}]",
            flush=True)


    # a launch's small tables (the shapes of frag1m: 556 substeps), one
    # copy each against one packed copy
    from lz4tpu_torch.device import to_device_packed

    small = [rng.integers(0, 9, 556).astype(np.int32),
             rng.integers(0, 16, (556, 8)).astype(np.int32),
             np.array([[0, 556, 0]], np.int32)]
    got = to_device_packed(small, dev)
    torch.cuda.synchronize()
    need(all(np.array_equal(t.cpu().numpy(), a) for t, a in zip(got, small)),
         "to_device_packed: the small tables differ after staging")
    ways = {"pinned, one copy each": lambda: [to_device(a, dev)
                                              for a in small],
            "pageable, one copy each": lambda: [torch.from_numpy(a).to(dev)
                                                for a in small],
            "pinned, one packed copy": lambda: to_device_packed(small, dev)}
    times = {k: [] for k in ways}
    for i in range(7):
        for k in (list(ways) if i % 2 == 0 else list(ways)[::-1]):
            torch.cuda.synchronize()
            s = time.perf_counter()
            t = ways[k]()
            times[k].append(1e3 * (time.perf_counter() - s))
            del t
    print("[staging] three small tables of one launch (2224 + 17792 + 12 B): "
          + ", ".join(f"{k} returns after {statistics.median(t):.4f} ms"
                      for k, t in times.items())
          + f" (host clock, median of 7, in turns) [{name_card}]", flush=True)


def busy_phase(torch, lt, corp, name_card, calls=3):
    """Device busy share of decompress_to_device(verify="host"): the
    time the profiler saw the card work (kernels and copies) over the
    host-clock time of ``calls`` synchronised calls."""
    from torch.profiler import ProfilerActivity, profile

    for name in ("frag1m", "src1m", "frag32m"):
        data = corp[name][0]
        lt.decompress_to_device(data)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                lt.decompress_to_device(data)
                torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))

        # rows of the card's own activity (kernels, copies); a host-side
        # operator's row repeats the device time of what it launched
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_ms = sum(dev_us(e) for e in events) / 1e3
        top = sorted(events, key=lambda e: -dev_us(e))[:3]
        if busy_ms <= 0:
            print(f"[busy] {name}: the profiler recorded no device time; "
                  "busy share not measured", flush=True)
            continue
        print(f"[busy] {name}: device busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}% over "
              f"{calls} calls of decompress_to_device(verify='host'); most: "
              + ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms"
                          for e in top) + f" [{name_card}]", flush=True)


def corrupted_frames(corp) -> dict:
    """A block under its checksum and a content checksum, each flipped."""
    block = bytearray(corp["frag2m-bsum"][0])
    block[300] ^= 0x20          # inside block 0, under its checksum
    content = bytearray(corp["frag1m"][0])
    content[-1] ^= 0x01         # the content checksum
    return {"corrupted block": bytes(block),
            "flipped content checksum": bytes(content)}


def error_phase(lt, corp):
    for what, data in corrupted_frames(corp).items():
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


def soak_phase(_kernels, name_card):
    """The soak (``lz4tpu_torch.exp.soak``) on its fixed seeds: any
    difference from the host engine, a sound frame served by the host
    fallback, or a decode kernel or engine the rounds never reached
    fails the smoke.  Returns the launches of its rounds."""
    from lz4tpu_torch.exp import soak

    _kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        cover = soak.soak(SOAK_SEED, "cuda", rounds=SOAK_ROUNDS)
        cover.require("cuda")
    except soak.SoakFailure as e:
        raise SmokeFailure(f"soak: {e}") from e
    secs = time.perf_counter() - t0
    counts = dict(_kernels.LAUNCHES)
    need(counts["mxu2_route_ab"] == 0, "the soak launched mxu2_route_ab")
    print(f"[soak] seeds {SOAK_SEED}..{SOAK_SEED + SOAK_ROUNDS - 1}: "
          f"{cover.rounds} rounds in {secs:.2f} s, every device path "
          f"equal to the host engine [{name_card}]", flush=True)
    for line in cover.lines():
        print(line, flush=True)
    return counts


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


def sharded_corpora(lt, corp):
    """What the sharded path decodes: the served corpora and z9m-indep
    (z9m in independent 4 MiB blocks: three sparse chains, 4, 4 and 1
    MiB)."""
    cases = {name: corp[name][:2] for name in SERVED}
    z9m = corp["z9m"][1]
    cases["z9m-indep"] = (lt.compress(z9m, block_independence=True), z9m)
    return cases


# each corpus's tier and exact launches on one entry and on four:
# "resolver" is tier 3 (torch ops, no kernel of ours), "spans" four span
# units (three with a seeded ring), "chains" chain groups.  On one entry
# every single-chain corpus takes the resolver.
FUSED4 = {"fused_expand": 4, "fused_route": 4}
SHARDED_ONE = {"frag32m-indep": ("chains", {"fused_expand": 2,
                                            "fused_route": 2}),
               "z9m-indep": ("chains", {"block_fill": 3})}
SHARDED_FOUR = {"z9m": ("resolver", {}), "b3.5m": ("resolver", {}),
                "frag1m": ("spans", FUSED4), "frag32m": ("spans", FUSED4),
                "frag2m-bsum": ("spans", FUSED4),
                "frag2m-legacy": ("spans", FUSED4),
                "frag32m-indep": ("chains", FUSED4),
                "src1m": ("chains", {"mxu2_route": 1, "dense_codes": 1}),
                "z9m-indep": ("chains", {"block_fill": 3})}


@contextlib.contextmanager
def host_decode_refused():
    """Within: a call of the host engine from inside a device entry
    point (``pipeline._host_fallback``, taken on any Lz4Error, a wrong
    device result under a content checksum among them) fails the smoke
    when the block ends, so every byte of a sound frame comes from the
    card."""
    from lz4tpu_torch import pipeline

    before = pipeline.HOST_FALLBACKS
    yield
    n = pipeline.HOST_FALLBACKS - before
    need(n == 0, f"a sound frame fell back to the host engine ({n} "
                 "call(s) of pipeline._host_fallback)")


def sharded_tier(np, lt, tpl, dist, data, mesh):
    """``(tier, units)`` that decompress_sharded takes for ``data`` on
    ``mesh`` (a pure function of the table and the mesh size)."""
    buf, _p, table, _plan, _st = plan_of(np, lt, tpl, data)
    if not dist._use_chains(table, mesh.size):
        return "resolver", None
    units, split = dist._work_units(table, buf, mesh.size)
    return ("spans" if split else "chains"), units


def sharded_path(torch, np, lt, tpl, _kernels, corp, name_card):
    """decompress_sharded on a one-entry mesh (make_mesh(): cuda:0) and
    on four entries of cuda:0, each on its own stream: every corpus's
    bytes (made on the card: no fallback to decompress_host), its tier
    and the exact launches of each kernel, decode_sharded's bytes for
    resolver corpora, decode_sharded_chains_to_device's segments against
    the bytes at their offsets, sharded_span_assignment as a partition
    of the output, and corrupted frames raising what decompress_host
    raises."""
    from lz4tpu_torch import dist

    one = dist.make_mesh()
    four = dist.Mesh(["cuda:0"] * 4)
    need(one.size == 1 and one.entries[0].device == torch.device("cuda", 0),
         f"make_mesh() on one card gave {one}")
    need(len({id(e.stream) for e in four.entries}) == 4,
         "the four entries do not have a stream each")
    cases = sharded_corpora(lt, corp)
    errors = {}
    for what, data in corrupted_frames(corp).items():
        try:
            lt.decompress_host(data)
        except lt.Lz4Error as e:
            errors[what] = (data, e)
    need(len(errors) == 2, "decompress_host accepted a corrupted frame")
    _kernels.reset_launches()
    for label, mesh in (("1 entry", one), ("4 entries", four)):
        for name, (data, blob) in cases.items():
            tier, units = sharded_tier(np, lt, tpl, dist, data, mesh)
            want, runs = (SHARDED_ONE.get(name, ("resolver", {}))
                          if mesh.size == 1 else SHARDED_FOUR[name])
            need(tier == want, f"{name} on {label}: tier {tier}, expected "
                               f"{want}")
            before = dict(_kernels.LAUNCHES)
            s = time.perf_counter()
            with host_decode_refused():
                out = dist.decompress_sharded(data, mesh)
            ms = 1e3 * (time.perf_counter() - s)
            need(out == blob, f"{name}: decompress_sharded on {label} "
                              "differs from the original")
            ran = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
            ran = {k: v for k, v in ran.items() if v}
            need(ran == runs, f"{name} on {label}: launched {ran}, expected "
                              f"{runs}")
            seeded = 0
            if tier == "spans":
                spans = [u for u in units if isinstance(u, dist.SpanUnit)]
                seeded = sum(u.ring is not None for u in spans)
                need(len(spans) == 4 and seeded == 3,
                     f"{name} on {label}: {len(spans)} span units, "
                     f"{seeded} seeded")
            print(f"[sharded] {name} on {label}: tier {tier}"
                  + (f", {len(units)} units, {seeded} with a seeded ring"
                     if units else "")
                  + f", {ms:.3f} ms (first call), launches {ran} "
                  f"[{name_card}]", flush=True)
            buf, _p, table, _plan, _st = plan_of(np, lt, tpl, data)
            if tier == "resolver":
                got = dist.decode_sharded(table, buf, mesh)
                need(got.tobytes() == blob, f"{name} on {label}: "
                                            "decode_sharded differs")
                continue
            segs = dist.decode_sharded_chains_to_device(table, buf, mesh)
            got = sorted((lo, lo + t.shape[0]) for lo, t in segs)
            need(got == dist.sharded_span_assignment(table, buf, mesh)[0]
                 and got[0][0] == 0 and got[-1][1] == len(blob)
                 and all(a[1] == b[0] for a, b in zip(got, got[1:])),
                 f"{name} on {label}: segments {got[:4]}... do not "
                 "partition the output as sharded_span_assignment says")
            for lo, t in segs:
                need(t.is_cuda, f"{name} on {label}: the segment at {lo} "
                                "is not on the card")
                need(t.cpu().numpy().tobytes() == blob[lo:lo + t.shape[0]],
                     f"{name} on {label}: the segment at {lo} differs")
        for what, (data, want) in errors.items():
            try:
                dist.decompress_sharded(data, mesh)
            except lt.Lz4Error as e:
                got = e
            else:
                raise SmokeFailure(f"decompress_sharded decoded the {what}")
            need(type(got) is type(want) and str(got) == str(want),
                 f"error parity ({what}, {label}): {type(got).__name__}"
                 f"({got}) vs {type(want).__name__}({want})")
        print(f"[sharded] corrupted frames on {label}: the classes and "
              "messages of decompress_host", flush=True)
    return dict(_kernels.LAUNCHES)


# what the numpy_prep path decodes, and the native functions it refuses
NUMPY_PREP = ("z9m", "b3.5m", "frag1m", "src1m", "frag2m-bsum",
              "frag2m-legacy", "frag32m-indep")
NATIVE_PREP = ("prep_fused_chain", "prep_fused_chain_pre",
               "pack_dense2_chain", "resolve_window")


@contextlib.contextmanager
def native_prep_off():
    """Within: ``native.available()`` is False, so the port plans with
    its numpy host prep, as ``lz4tpu`` does without its engine; the
    native prep, pack and resolve functions are replaced by ones that
    fail the smoke (at once, and again when the block ends, should a
    caller swallow the exception).  Everything is restored on exit."""
    from lz4tpu_torch import native

    saved = {n: getattr(native, n) for n in ("available",) + NATIVE_PREP}
    reached = []

    def refuse(name):
        def f(*_a, **_k):
            reached.append(name)
            raise SmokeFailure(f"native.{name} ran with the engine off")
        return f

    try:
        native.available = lambda: False
        for name in NATIVE_PREP:
            setattr(native, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)
    need(not reached, f"native prep reached with the engine off: {reached}")


def numpy_prep_path(torch, np, lt, tpl, _kernels, corp, name_card,
                    pairs=5):
    """The decode entry points with the native host engine off (the
    numpy fused prep, mxu2 packer and span resolve, ``native_prep_off``):
    ``decompress_to_device(verify="device")`` on NUMPY_PREP,
    ``verify="host"`` on frag1m and src1m, one DecodeSession window over
    them, and ``decompress_sharded`` of frag1m and frag2m-legacy on four
    entries of cuda:0 (span units, their rings resolved in numpy).
    Every output must equal the host engine's bytes, with no host
    fallback and the same engines as with the native prep; each decode
    kernel must launch.  Then each corpus's ``plan`` ms with the numpy
    prep against the native prep's, in turns (host clock, median of
    ``pairs``)."""
    from lz4tpu_torch import dist

    t_phase = time.perf_counter()
    cases = {n: corp[n] for n in NUMPY_PREP}
    host = {n: lt.decompress_host(c[0]) for n, c in cases.items()}
    for n, c in cases.items():
        need(host[n] == c[1], f"{n}: the host engine differs from the "
                              "original")
    four = dist.Mesh(["cuda:0"] * 4)
    _kernels.reset_launches()
    fallbacks = tpl.HOST_FALLBACKS
    first_ms = {}
    with native_prep_off():
        for name, (data, _blob, engines, _f, _b) in cases.items():
            _b2, _p, _t, _plan, stats = plan_of(np, lt, tpl, data)
            need(stats.engine_chains == engines,
                 f"{name}: the numpy prep planned {stats.engine_chains}, "
                 f"the native {engines}")
            modes = ("device", "host") if name in ("frag1m", "src1m") \
                else ("device",)
            for mode in modes:
                s = time.perf_counter()
                res = lt.decompress_to_device(data, device="cuda",
                                              verify=mode)
                torch.cuda.synchronize()
                first_ms[name, mode] = 1e3 * (time.perf_counter() - s)
                need(res.is_cuda and res.cpu().numpy().tobytes()
                     == host[name], f"{name}: decompress_to_device(verify="
                                    f"{mode!r}) with the numpy prep differs")
        with lt.DecodeSession(max_inflight=4) as session:
            outs = windowed(session, [c[0] for c in cases.values()],
                            lambda t: t.result())
        need(outs == list(host.values()),
             "the session with the numpy prep differs from the host engine")
        for name in ("frag1m", "frag2m-legacy"):
            tier, _units = sharded_tier(np, lt, tpl, dist, cases[name][0],
                                        four)
            need(tier == "spans", f"{name} on 4 entries: tier {tier} with "
                                  "the numpy prep")
            s = time.perf_counter()
            out = dist.decompress_sharded(cases[name][0], four)
            first_ms[name, "sharded"] = 1e3 * (time.perf_counter() - s)
            need(out == host[name], f"{name}: decompress_sharded with the "
                                    "numpy prep differs")
    counts = dict(_kernels.LAUNCHES)
    need(tpl.HOST_FALLBACKS == fallbacks,
         f"{tpl.HOST_FALLBACKS - fallbacks} host fallback(s) with the "
         "numpy prep")
    for k in ("fused_expand", "fused_route", "mxu2_route", "block_fill",
              "xxh32_stream", "xxh32_blocks", "dense_codes"):
        need(counts[k] > 0, f"the numpy_prep path did not launch {k}")
    for name, (data, _blob, engines, _f, _b) in cases.items():
        buf = np.frombuffer(data, np.uint8)
        parsed = tpl.parse_frames(buf, lt.FOR_ALL)
        # the table decompress_to_device builds with the engine off (no
        # ``pre``: the single-block scan that makes it is native)
        with native_prep_off():
            t_np = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data,
                                       pooled_cols=True)
        t_nat = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data,
                                    pooled_cols=True)

        def plan_numpy():
            with native_prep_off():
                tpl.plan_decode(buf, parsed, t_np)

        ms = in_turns(torch, {
            "numpy": plan_numpy,
            "native": lambda: tpl.plan_decode(buf, parsed, t_nat)}, pairs)
        ratio = statistics.median(ms["numpy"]) / statistics.median(
            ms["native"])
        firsts = ", ".join(f"{m} {v:.3f} ms" for (n, m), v in
                           first_ms.items() if n == name)
        print(f"[numpy_prep] {name}: engines {engines}, plan numpy "
              f"{med_range(ms['numpy'])} against native "
              f"{med_range(ms['native'])}, ratio {ratio:.2f} (median of "
              f"{pairs}, in turns); first calls with the numpy prep: "
              f"{firsts} [{name_card}]", flush=True)
    print(f"[numpy_prep] launches {({k: v for k, v in counts.items() if v})}"
          f", host fallbacks 0; the phase {time.perf_counter() - t_phase:.2f}"
          f" s [{name_card}]", flush=True)
    return counts


def sharded_phase(torch, lt, corp, name_card, pairs=5, calls=3):
    """frag32m end to end in turns: decompress_to_device (one launch
    pair, output on the card) against decompress_sharded on one entry
    (the resolver) and on four entries of cuda:0 (four span units);
    then each one's device busy share with torch.profiler, and whether
    the four span units' fused_route launches overlapped on the card."""
    from torch.profiler import ProfilerActivity, profile

    from lz4tpu_torch import dist

    data = corp["frag32m"][0]
    one = dist.make_mesh()
    four = dist.Mesh(["cuda:0"] * 4)
    fns = {"decompress_to_device": lambda: lt.decompress_to_device(data),
           "decompress_sharded, 1 entry":
               lambda: dist.decompress_sharded(data, one),
           "decompress_sharded, 4 entries":
               lambda: dist.decompress_sharded(data, four)}
    with host_decode_refused():
        ms = in_turns(torch, fns, pairs)
    print("[sharded] frag32m: " + " against ".join(
        f"{k} {med_range(t)}" for k, t in ms.items())
        + f" (median and range of {pairs}, in turns) [{name_card}]",
        flush=True)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with host_decode_refused(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
                torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_ms = sum(dev_us(e) for e in rows) / 1e3
        need(busy_ms > 0, f"[busy] {name}: the profiler recorded no device "
                          "time")
        route_ms = sum(dev_us(e) for e in rows
                       if "fused_route" in e.key) / 1e3
        top = sorted(rows, key=lambda e: -dev_us(e))[:3]
        # fused_route kernels as intervals on the card's clock
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and "fused_route" in e.name)
        most, live, union, end = 0, [], 0.0, float("-inf")
        for a, b in spans:
            live = [x for x in live if x > a] + [b]
            most = max(most, len(live))
            union += max(0.0, b - max(a, end))
            end = max(end, b)
        print(f"[busy] frag32m, {name}: device busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms = {100 * busy_ms / wall_ms:.1f}% over "
              f"{calls} calls; fused_route {route_ms:.3f} ms in "
              f"{len(spans)} launches, at most {most} at once, on the card "
              f"for {union / 1e3 / calls:.3f} ms a call; most: "
              + ", ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms"
                          for e in top) + f" [{name_card}]", flush=True)
        if name.endswith("4 entries"):
            need(len(spans) == 4 * calls and most >= 2,
                 f"the four span units' fused_route launches did not "
                 f"overlap ({len(spans)} launches, at most {most} at once)")


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

ENCODED = ("src1m", "frag1m", "b3.5m", "z9m")
ENC_BACKENDS = ("device", "device-emit")
HISTORY = 65536
BLOCK = 4 << 20          # the default block; with its history: 4,259,840


@contextlib.contextmanager
def candidate_devices(enc):
    """Within: the device of every candidate and decision tensor that the
    device encoder's two passes return (the list yielded fills up)."""
    seen = []
    real = {n: getattr(enc, n) for n in ("_candidates_compact_device",
                                         "_emit_inputs_device")}

    def wrap(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            seen.extend(t.device for t in (out if isinstance(out, tuple)
                                           else (out,)))
            return out
        return run

    for n, fn in real.items():
        setattr(enc, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in real.items():
            setattr(enc, n, fn)


def encode_path(torch, lt, _kernels, corp, words, name_card):
    """compress(backend="device"|"device-emit") on cuda:0 over src1m,
    frag1m, b3.5m and z9m, held against the same calls with
    device="cpu"; words32m's first 8 MiB through backend="device";
    dist.compress_sharded on make_mesh() and on four entries of cuda:0
    over frag32m and z9m, held against compress(backend="device"); every
    candidate tensor on the card; every frame decoded back on the card
    by decompress_to_device (no fallback to decompress_host); then the
    CLI's lz4-bench as three subprocesses.  Returns the launch counts."""
    import tempfile

    from lz4tpu_torch import dist
    from lz4tpu_torch.device import encode as enc

    payloads = {name: corp[name][1] for name in ENCODED}
    s = time.perf_counter()
    want = {(n, be): lt.compress(p, backend=be, device="cpu")
            for n, p in payloads.items() for be in ENC_BACKENDS}
    print(f"[encode] the CPU's frames of {len(want)} encodes (torch ops "
          f"on the host) in {time.perf_counter() - s:.2f} s", flush=True)
    payloads["words32m[:8 MiB]"] = words[1][:8 << 20]
    sharded = {"frag32m": corp["frag32m"][1], "z9m": corp["z9m"][1]}
    meshes = (("1 entry", dist.make_mesh()),
              ("4 entries", dist.Mesh(["cuda:0"] * 4)))
    _kernels.reset_launches()
    frames = {}
    with candidate_devices(enc) as seen:
        for (name, be), ref in want.items():
            s = time.perf_counter()
            frames[(name, be)] = lt.compress(payloads[name], backend=be)
            ms = 1e3 * (time.perf_counter() - s)
            need(frames[(name, be)] == ref,
                 f"{name}: compress(backend={be!r}) on the card differs "
                 "from device='cpu'")
            print(f"[encode] {name} backend={be!r}: {len(payloads[name])} "
                  f"-> {len(ref)} B, the card's bytes equal the CPU's, "
                  f"{ms:.3f} ms (first call) [{name_card}]", flush=True)
        w8 = "words32m[:8 MiB]"
        frames[(w8, "device")] = lt.compress(payloads[w8], backend="device")
        for name, p in sharded.items():
            seq = lt.compress(p, backend="device")
            for label, mesh in meshes:
                s = time.perf_counter()
                got = dist.compress_sharded(p, mesh)
                ms = 1e3 * (time.perf_counter() - s)
                need(got == seq, f"{name}: compress_sharded on {label} "
                                 "differs from compress(backend='device')")
                print(f"[encode] {name}: compress_sharded on {label} equals "
                      f"compress(backend='device'), {len(got)} B, "
                      f"{ms:.3f} ms [{name_card}]", flush=True)
    need(seen and all(d.type == "cuda" for d in seen),
         f"candidate tensors off the card: {set(seen)}")
    payloads.update(sharded)
    with host_decode_refused():
        for (name, be), frame in frames.items():
            out = lt.decompress_to_device(frame)
            need(out.is_cuda and out.cpu().numpy().tobytes()
                 == payloads[name],
                 f"{name}: the frame of backend={be!r} does not decode "
                 "back on the card")
    counts = dict(_kernels.LAUNCHES)
    print(f"[encode] {len(frames)} frames decoded back on the card, "
          f"{len(seen)} candidate tensors, all on cuda; launches "
          f"{ {k: v for k, v in counts.items() if v} } [{name_card}]",
          flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "src1m.lz4").write_bytes(corp["src1m"][0])
        (tmp / "src1m.bin").write_bytes(corp["src1m"][1])
        for args in (["--backend", "device", "src1m.lz4"],
                     ["--encode", "--backend", "device", "src1m.bin"],
                     ["--backend", "device", "--profile", "trace",
                      "src1m.lz4"]):
            argv = [sys.executable, "-m", "lz4tpu_torch.cli", "lz4-bench",
                    "--reps", "2", *args]
            env = {**os.environ, "PYTHONPATH": str(HERE)}
            r = subprocess.run(argv, cwd=tmp, env=env, capture_output=True,
                               text=True, timeout=300)
            need(r.returncode == 0, f"lz4-bench {' '.join(args)}: rc "
                                    f"{r.returncode}: {r.stderr[-2000:]}")
            print(f"[cli] python -m lz4tpu_torch.cli lz4-bench "
                  f"{' '.join(args)}: rc 0; "
                  + " | ".join(r.stderr.strip().splitlines())
                  + f" [{name_card}]", flush=True)
        need((tmp / "trace" / "trace.json").is_file(),
             "lz4-bench --profile wrote no trace")
    return counts


def device_busy(torch, fn):
    """``(device ms, kernels, host ms)`` of one synchronised fn() under
    torch.profiler, after a warm call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - s)
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) for e in rows)
    return us / 1e3, sum(e.count for e in rows), wall


def encode_phase(torch, np, lt, corp, dev, name_card):
    """The device encoder's passes on one default block (frag32m's
    second 4 MiB with its 64 KiB of history, 4,259,840 bytes): each
    stage by CUDA events, the copy of the result to the host, the host
    emitters, the plain run (the same ops on the CPU), peak device
    memory, and end-to-end encode rates on frag32m; compress_sharded's
    peak memory on 16 blocks."""
    from lz4tpu_torch import dist, native
    from lz4tpu_torch.device import emit_levels as el
    from lz4tpu_torch.device import encode as enc
    from lz4tpu_torch.device import to_device

    frag32m = corp["frag32m"][1]
    joined = np.frombuffer(frag32m[BLOCK - HISTORY:2 * BLOCK], np.uint8)
    n = n_pad = joined.size
    need(n % 1024 == 0, "the block's width is not a multiple of 1024")
    buf = to_device(joined, dev)
    pos = torch.arange(n_pad, dtype=torch.int32, device=dev)
    bound = (n + 4 * n) / HBM_BYTES_PER_S * 1e3
    reps = 10

    g4, g8 = enc._compact_grams(buf)
    o4 = enc._sort_order([g4])
    o8 = enc._sort_order([g4, g8])
    c4 = enc._nearest_prev(o4, [g4], pos)
    c8 = enc._nearest_prev(o8, [g4, g8], pos)
    d = enc._candidates_compact_device(buf, n_pad=n_pad)
    compact = {
        "grams": cuda_ms(torch, lambda: enc._compact_grams(buf), reps),
        "sorts": cuda_ms(torch, lambda: (enc._sort_order([g4]),
                                         enc._sort_order([g4, g8])), reps),
        "compare": cuda_ms(torch, lambda: (
            enc._delta(enc._nearest_prev(o4, [g4], pos), pos),
            enc._delta(enc._nearest_prev(o8, [g4, g8], pos), pos)), reps),
        "restore": cuda_ms(torch, lambda: (enc._restore(o4, c4),
                                           enc._restore(o8, c8)), reps),
        "whole pass": cuda_ms(torch, lambda: enc._candidates_compact_device(
            buf, n_pad=n_pad), reps),
        "copy to host": cuda_ms(torch, lambda: d.cpu(), reps),
    }

    g = enc._gram_words(buf)
    order = enc._sort_order(g)
    ws = [w.gather(-1, order) for w in g]
    p_s = order.to(torch.int32)
    dlev = enc._level_deltas(ws, p_s)
    h8 = el.emit_levels(buf, p_s)
    need(all(torch.equal(h8[k], dk) for k, dk in dlev.items()),
         "emit_levels differs from _level_deltas on frag32m's block")
    del h8
    lev = [(k, torch.where(pos + k <= n, enc._restore(order, dk), 0))
           for k, dk in sorted(dlev.items())]
    elen, eoff = enc._emit_inputs_device(buf, n, n_pad=n_pad)
    emit = {
        "grams": cuda_ms(torch, lambda: enc._gram_words(buf), reps),
        "sort": cuda_ms(torch, lambda: (lambda o: [w.gather(-1, o)
                                                   for w in g])(
            enc._sort_order(g)), reps),
        "scans": cuda_ms(torch, lambda: enc._level_deltas(ws, p_s), 3),
        "levels (H8)": cuda_ms(torch, lambda: el.emit_levels(buf, p_s),
                               reps),
        "restore": cuda_ms(torch, lambda: [
            torch.where(pos + k <= n, enc._restore(order, dk), 0)
            for k, dk in sorted(dlev.items())], reps),
        "combine": cuda_ms(torch, lambda: enc._combine_levels(lev, n, n_pad),
                           reps),
        "whole pass": cuda_ms(torch, lambda: enc._emit_inputs_device(
            buf, n, n_pad=n_pad), 3),
        "copy to host": cuda_ms(torch, lambda: (elen.cpu(), eoff.cpu()),
                                reps),
    }
    del g, order, ws, p_s, dlev, lev, g4, g8, o4, o8, c4, c8

    d_host = d.cpu().numpy()
    cand = enc.deltas_to_positions(d_host)
    e_l, e_o = elen.cpu().numpy(), eoff.cpu().numpy()
    host = {"deltas_to_positions": host_ms(
                torch, lambda: enc.deltas_to_positions(d_host), 3),
            "compress_block_cands": host_ms(torch, lambda: (
                native.compress_block_cands(joined, HISTORY, BLOCK, cand)),
                3),
            "emit_quantized": host_ms(torch, lambda: native.emit_quantized(
                joined, HISTORY, BLOCK, e_l, e_o), 3)}

    peak = {}
    for name, fn in (("compact pass", lambda: enc._candidates_compact_device(
                          buf, n_pad=n_pad)),
                     ("emission pass", lambda: enc._emit_inputs_device(
                          buf, n, n_pad=n_pad))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() - base

    busy = {}
    for name, fn in (("compact pass", lambda: enc._candidates_compact_device(
                          buf, n_pad=n_pad)),
                     ("emission pass", lambda: enc._emit_inputs_device(
                          buf, n, n_pad=n_pad))):
        busy[name] = device_busy(torch, fn)

    cpu_buf = torch.from_numpy(joined.copy())
    s = time.perf_counter()
    enc._candidates_compact_device(cpu_buf, n_pad=n_pad)
    plain_compact = 1e3 * (time.perf_counter() - s)
    s = time.perf_counter()
    enc._emit_inputs_device(cpu_buf, n, n_pad=n_pad)
    plain_emit = 1e3 * (time.perf_counter() - s)

    for what, st, plain in (("compact pass", compact, plain_compact),
                            ("emission pass", emit, plain_emit)):
        print(f"[encode] {what}, one block of {n} B (4 MiB + 64 KiB "
              "history): " + ", ".join(f"{k} {v:.4f}" for k, v in st.items())
              + f" ms (CUDA events, median); bound {bound:.4f} ms (bytes: "
              f"{n} B in, {4 * n} B out, loose); plain (the same ops on "
              f"the CPU, once) {plain:.1f} ms; peak device memory "
              f"{peak[what]} B; torch.profiler: {busy[what][1]} kernels, "
              f"busy {busy[what][0]:.3f} ms of {busy[what][2]:.3f} ms "
              f"(host clock) [{name_card}]", flush=True)
    print("[encode] host emission of that block: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in host.items())
        + f" (host clock, median of 3) [{name_card}]", flush=True)

    mb = len(frag32m) / 1e6
    ways = {"compress(backend='device')":
                lambda: lt.compress(frag32m, backend="device"),
            "compress(backend='device-emit')":
                lambda: lt.compress(frag32m, backend="device-emit"),
            "compress(backend='host'), level 6":
                lambda: lt.compress(frag32m),
            "dist.compress_sharded, make_mesh()":
                lambda: dist.compress_sharded(frag32m)}
    for name, fn in ways.items():
        ms = host_ms(torch, fn, 2)
        print(f"[encode] frag32m end to end, {name}: {ms:.3f} ms = "
              f"{mb / ms * 1e3:.3f} MB/s of payload (host clock, median "
              f"of 2 after a warm call) [{name_card}]", flush=True)

    sixteen = frag32m + frag32m[::-1]       # 64 MiB: 16 blocks of 4 MiB
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    out = dist.compress_sharded(sixteen)
    ms = 1e3 * (time.perf_counter() - s)
    need(lt.decompress_host(out) == sixteen,
         "compress_sharded on 16 blocks does not round-trip")
    print(f"[encode] compress_sharded, 16 blocks of 4 MiB on make_mesh(): "
          f"peak device memory {torch.cuda.max_memory_allocated() - base} "
          f"B, {ms:.3f} ms (one call) [{name_card}]", flush=True)


# The wheel phase's program, run by the interpreter of the smoke with the
# installed tree alone on its path (argv: site, inputs, checkout).  It
# builds the kernels into the installed tree's _build/, then drives the
# main path over the input files on the card and prints one JSON line.
WHEEL_MAIN = r'''
import sys
sys.modules["jax"] = None            # any `import jax` now fails
sys.modules["lz4tpu"] = None         # and any `import lz4tpu`
import hashlib
import json
import pathlib
import time

site, inputs, checkout = (pathlib.Path(a).resolve() for a in sys.argv[1:4])
if any(pathlib.Path(p or ".").resolve() == checkout for p in sys.path):
    raise SystemExit(f"the checkout is on sys.path: {sys.path}")
import torch
import lz4tpu_torch as lt
from lz4tpu_torch import _kernels, native, pipeline
from lz4tpu_torch.device import encode as enc

pkg = site / "lz4tpu_torch"
if pathlib.Path(lt.__file__).resolve().parent != pkg:
    raise SystemExit(f"lz4tpu_torch imported from {lt.__file__}")
if _kernels.BUILD_DIR.resolve() != pkg / "_build":
    raise SystemExit(f"kernel cache at {_kernels.BUILD_DIR}")
t0 = time.perf_counter()
so = _kernels.build()
t1 = time.perf_counter()
_kernels.lib()
if not native.available():
    raise SystemExit("the native engine did not build in the tree")
t2 = time.perf_counter()
maps = {ln.split()[-1] for ln in open("/proc/self/maps")
        if ln.rstrip().endswith((_kernels.LIB_NAME, "_lz4core.so"))}
seen = []
real = enc._candidates_compact_device
def _candidates(*a, **k):
    out = real(*a, **k)
    seen.extend(str(t.device) for t in (out if isinstance(out, tuple)
                                        else (out,)))
    return out
enc._candidates_compact_device = _candidates

_kernels.reset_launches()
fallbacks = pipeline.HOST_FALLBACKS
calls = {}
for name, how in json.loads(sys.argv[4]):
    data = (inputs / name).read_bytes()
    before = dict(_kernels.LAUNCHES)
    s = time.perf_counter()
    if how == "to_device":
        t = lt.decompress_to_device(data, verify="device")
        torch.cuda.synchronize()
        if not t.is_cuda:
            raise SystemExit(f"{name}: the result is not on the card")
        out = t.cpu().numpy().tobytes()
    elif how == "pallas":
        out = lt.decompress_device(data, engine="pallas")
    else:                               # encode on the card, decode back
        frames = [lt.compress(data, backend="device"),
                  lt.compress(data, backend="device-emit")]
        for frame in frames:
            t = lt.decompress_to_device(frame, verify="device")
            if t.cpu().numpy().tobytes() != data:
                raise SystemExit(f"{name}: the device encoder's frame does "
                                 "not decode back on the card")
        out, data = data, frames[0]
    ms = 1e3 * (time.perf_counter() - s)
    if out != lt.decompress_host(data):
        raise SystemExit(f"{name} ({how}): differs from the host engine")
    calls[name] = {"how": how, "bytes": len(out), "ms": ms,
                   "sha256": hashlib.sha256(out).hexdigest(),
                   "launches": {k: v - before[k]
                                for k, v in _kernels.LAUNCHES.items()}}
print(json.dumps({
    "file": lt.__file__, "build_dir": str(_kernels.BUILD_DIR),
    "library": str(so), "loaded": sorted(maps),
    "nvcc_s": t1 - t0, "native_s": t2 - t1,
    "nvcc_log": (_kernels.BUILD_DIR / "nvcc.log").is_file(),
    "launches": dict(_kernels.LAUNCHES), "calls": calls,
    "host_fallbacks": pipeline.HOST_FALLBACKS - fallbacks,
    "encoder_devices": sorted(set(seen)),
    "modules": sorted({m.split(".")[0] for m, v in sys.modules.items()
                       if v is not None})}))
'''

# What the wheel phase decodes on the card, and the kernels each call
# must launch: (input file, call, kernels)
WHEEL_CALLS = (
    ("words32m.lz4", "to_device", ("mxu2_route", "xxh32_stream",
                                   "dense_codes")),
    ("frag32m.lz4", "to_device", ("fused_expand", "fused_route")),
    ("z9m.lz4", "to_device", ("block_fill",)),
    ("frag32m-bsum64k.lz4", "to_device", ("xxh32_blocks",)),
    ("indep2m.lz4", "pallas", ("segment_decode",)),
    ("frag32m-block2.bin", "encode", ("emit_levels",)),
)


def wheel_phase(np, lt, corp, words, name_card):
    """The port as a user installs it: the wheel built with setuptools'
    PEP 517 backend from a copy of the checkout, installed with ``pip
    install --target`` into a temporary directory, and one process with
    that tree alone on its path (``jax`` and ``lz4tpu`` blocked,
    ``LZ4TPU_*`` unset, the working directory the temporary one).  It
    builds the kernels into ``<site>/lz4tpu_torch/_build/`` and drives
    the main path over the bench-size corpora (:data:`WHEEL_CALLS`):
    every output equal to the installed host engine's and to the
    original, every kernel launched, no host fallback; then the
    installed ``lz4tpu-bench-torch --backend device`` on one frame.
    Returns the installed package's launch counts."""
    import hashlib
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    origs = {"words32m.lz4": words[1], "frag32m.lz4": corp["frag32m"][1],
             "z9m.lz4": corp["z9m"][1],
             "frag32m-bsum64k.lz4": corp["frag32m-bsum64k"][1]}
    comp = {"words32m.lz4": words[0], "frag32m.lz4": corp["frag32m"][0],
            "z9m.lz4": corp["z9m"][0],
            "frag32m-bsum64k.lz4": corp["frag32m-bsum64k"][0]}
    comp["indep2m.lz4"], origs["indep2m.lz4"] = indep2m(np, lt)
    block2 = corp["frag32m"][1][BLOCK:2 * BLOCK]
    comp["frag32m-block2.bin"] = origs["frag32m-block2.bin"] = block2
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LZ4TPU_")}
    with tempfile.TemporaryDirectory(prefix="lz4tpu_wheel_") as tmp:
        tmp = pathlib.Path(tmp)
        src, out, site, inputs = (tmp / d for d in ("src", "dist", "site",
                                                    "inputs"))
        t0 = time.perf_counter()
        skip = shutil.ignore_patterns("__pycache__", "*.so", "_build",
                                      "build")
        for name in ("lz4tpu", "lz4tpu_torch"):
            shutil.copytree(HERE / name, src / name, ignore=skip)
        for name in ("pyproject.toml", "README.md", "LICENSE"):
            shutil.copy(HERE / name, src / name)
        r = subprocess.run(
            [sys.executable, "-c",
             "import sys\nfrom setuptools import build_meta\n"
             "out = sys.argv[1]\n"      # the backend rewrites sys.argv
             "build_meta.build_wheel(out)\n", str(out)],
            cwd=src, env=env, capture_output=True, text=True, timeout=300)
        need(r.returncode == 0, f"wheel build failed: {r.stderr[-3000:]}")
        wheel, = out.glob("*.whl")
        t1 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "pip", "install", "--no-deps",
             "--no-index", "--no-compile", "--disable-pip-version-check",
             "--target", str(site), str(wheel)],
            env=env, capture_output=True, text=True, timeout=300)
        need(r.returncode == 0, f"pip install failed: {r.stderr[-3000:]}")
        t2 = time.perf_counter()
        need(not list(site.rglob("*.so")), "the wheel installed a binary")
        inputs.mkdir()
        for name, blob in comp.items():
            (inputs / name).write_bytes(blob)
        env["PYTHONPATH"] = str(site)
        calls = [[name, how] for name, how, _k in WHEEL_CALLS]
        r = subprocess.run(
            [sys.executable, "-c", WHEEL_MAIN, str(site), str(inputs),
             str(HERE), json.dumps(calls)],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        need(r.returncode == 0, "the installed tree's main path failed "
                                f"(rc {r.returncode}): {r.stderr[-3000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        t3 = time.perf_counter()
        pkg = site.resolve() / "lz4tpu_torch"
        need(pathlib.Path(res["file"]).resolve().parent == pkg,
             f"imported {res['file']}, not the installed tree")
        need(pathlib.Path(res["build_dir"]).resolve() == pkg / "_build"
             and res["nvcc_log"], f"kernels built in {res['build_dir']}")
        need(res["loaded"] and all(pathlib.Path(p).resolve()
                                   .is_relative_to(site.resolve())
                                   for p in res["loaded"]),
             f"libraries loaded from outside the tree: {res['loaded']}")
        need("jax" not in res["modules"] and "lz4tpu" not in res["modules"],
             "the installed tree imported jax or lz4tpu")
        need(res["host_fallbacks"] == 0,
             f"{res['host_fallbacks']} host fallback(s) in the installed "
             "tree's main path")
        need(res["encoder_devices"] == ["cuda:0"],
             f"the device encoder ran on {res['encoder_devices']}")
        for name, how, kernels in WHEEL_CALLS:
            c = res["calls"][name]
            need(c["sha256"] == hashlib.sha256(origs[name]).hexdigest(),
                 f"{name} ({how}): the installed tree's bytes differ from "
                 "the original")
            for k in kernels:
                need(c["launches"][k] > 0,
                     f"{name} ({how}): kernel {k} was not launched")
        need(not (HERE / "build" / "lz4tpu_torch").exists(),
             "the checkout has a build/lz4tpu_torch/")
        bench = site / "bin" / "lz4tpu-bench-torch"
        r = subprocess.run(
            [str(bench), "--backend", "device", "--reps", "1", "--stats",
             str(inputs / "frag32m.lz4")],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        need(r.returncode == 0 and
             f"-> {len(origs['frag32m.lz4'])} B" in r.stderr,
             f"lz4tpu-bench-torch: rc {r.returncode}: {r.stderr[-2000:]}")
        t4 = time.perf_counter()
    decoded = sum(c["bytes"] for c in res["calls"].values())
    print(f"[wheel] built in {t1 - t0:.2f} s, pip install --target in "
          f"{t2 - t1:.2f} s, nvcc into the installed tree in "
          f"{res['nvcc_s']:.2f} s (native engine {res['native_s']:.2f} s), "
          f"main path and checks in {t3 - t2:.2f} s, {decoded} B decoded, "
          f"every output equal to the host engine's, 0 host fallbacks; "
          f"lz4tpu-bench-torch in {t4 - t3:.2f} s; phase "
          f"{time.perf_counter() - t_phase:.2f} s; launches "
          f"{ {k: v for k, v in res['launches'].items() if v} }; cache "
          f"{res['build_dir']} [{name_card}]", flush=True)
    for name, c in res["calls"].items():
        print(f"[wheel] {name} ({c['how']}): {c['bytes']} B, "
              f"{c['ms']:.3f} ms (first call), launches "
              f"{ {k: v for k, v in c['launches'].items() if v} } "
              f"[{name_card}]", flush=True)
    print("[wheel] lz4tpu-bench-torch: "
          + " | ".join(r.stderr.strip().splitlines())
          + f" [{name_card}]", flush=True)
    return res["launches"]


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
    # ptxas names a kernel ("Compiling entry function '<mangled>'") and
    # then says what it uses
    ptxas, entry = [], "?"
    for ln in (_kernels.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            entry = kernel_name(ln.split("'")[1])
        elif "Used" in ln:
            ptxas.append(f"{entry}: " + ln.split(":", 1)[1].strip())
    print(f"[build] CUDA kernels {t1 - t0:.2f} s (nvcc, sm_90a, one process "
          f"per source), native engine {t2 - t1:.2f} s", flush=True)
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)

    t0 = time.perf_counter()
    corp = corpora(np, lt)
    print(f"[corpora] {len(corp)} made and compressed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    words = words32m(np, lt)
    print(f"[corpora] words32m made and compressed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rows = kernel_phase(torch, np, lt, tpl, corp, words, dev, card, probe)
    paths = {}
    paths["verify_host"] = to_device_path(
        torch, np, lt, tpl, _kernels, corp, dev, card, "host",
        extra={"words32m": (*words, {"dense": 1}, False, False)})
    paths["verify_device"] = to_device_path(
        torch, np, lt, tpl, _kernels, corp, dev, card, "device")
    paths["decompress_device"] = decompress_device_path(
        torch, np, lt, tpl, _kernels, corp, dev, card)
    paths["ab"] = ab_path(torch, lt, _kernels, corp, card)
    paths["session"] = session_path(torch, lt, tpl, _kernels, corp, dev,
                                    card)
    paths["sharded"] = sharded_path(torch, np, lt, tpl, _kernels, corp,
                                    card)
    paths["numpy_prep"] = numpy_prep_path(torch, np, lt, tpl, _kernels,
                                          corp, card)
    paths["encode"] = encode_path(torch, lt, _kernels, corp, words, card)
    verify_compare(torch, lt, corp, card)
    sustained_phase(torch, np, lt, tpl, corp, card)
    staging_phase(torch, np, dev, card)
    busy_phase(torch, lt, corp, card)
    sharded_phase(torch, lt, corp, card)
    encode_phase(torch, np, lt, corp, dev, card)
    torch.cuda.empty_cache()        # the installed tree's process shares
    paths["wheel"] = wheel_phase(np, lt, corp, words, card)    # the card
    for name in KERNELS:
        need(sum(p[name] for p in paths.values()) > 0,
             f"kernel {name} was never launched by a path")
    error_phase(lt, corp)
    # the soak launches every decode kernel: it stays out of the check
    # above, so that a fixed path that stops launching its kernel fails
    paths["soak"] = soak_phase(_kernels, card)
    launches = {k: sum(p[k] for p in paths.values()) for k in KERNELS}
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
