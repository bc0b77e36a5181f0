#!/usr/bin/env python3
"""Drive lz4tpu_torch's decode path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
g++:  ``python3 chip_smoke.py``.  It

1. prints the environment, the card and its power limit;
2. builds the CUDA kernels (csrc/*.cu, nvcc, sm_90a) and the native
   host engine from the checkout, and times the build;
3. runs each kernel and its plain PyTorch version on the card at the
   main path's shapes and requires equal bytes (tolerance 0: the
   output is uint8), timing both with CUDA events;
4. decodes seeded in-process corpora through
   ``lz4tpu_torch.decompress_to_device(data, device="cuda")`` and
   requires the original bytes, the planned engines, and the matching
   kernel launch counters;
5. checks that a corrupted frame raises what ``lz4tpu.decompress_host``
   raises;
6. prints one JSON line per kernel, the card line, and last
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
TOL = 0          # uint8 outputs compare exactly

KERNELS = {      # name -> (source, TPU kernel it replaces)
    "fused_expand": ("lz4tpu_torch/csrc/fused.cu",
                     "lz4tpu/device/fused.py:787"),
    "fused_route": ("lz4tpu_torch/csrc/fused.cu",
                    "lz4tpu/device/fused.py:787"),
    "mxu2_route": ("lz4tpu_torch/csrc/mxu2.cu",
                   "lz4tpu/device/mxu2.py:184"),
    "block_fill": ("lz4tpu_torch/csrc/block_fill.cu",
                   "lz4tpu/device/sparse_decode.py:228"),
}
ENGINE_KERNELS = {"fused": ("fused_expand", "fused_route"),
                  "dense": ("mxu2_route",)}


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
    """The checkout's own .py/.md/.cpp text in sorted path order."""
    skip = {"build", "__pycache__"}
    files = sorted(
        p for p in HERE.rglob("*")
        if p.suffix in (".py", ".md", ".cpp") and p.is_file()
        and not any(part.startswith(".") or part in skip
                    for part in p.relative_to(HERE).parts))
    blob = b"".join(p.read_bytes() for p in files)
    need(len(blob) >= n, f"repo text is {len(blob)} bytes, need {n}")
    return blob[:n]


def corpora(np, lz4tpu):
    """name -> (compressed, original, expected engine mix, block fill)"""
    z9m = bytes(9_437_166)
    b35 = np.random.default_rng(0).integers(
        0, 256, 3_500_000, dtype=np.uint8).tobytes()
    frag1m = frag_text(np, 1_137_664, 8192, 3, 8, 11)
    src1m = repo_text(1 << 20)
    frag32m = frag_text(np, 32 << 20, 2048, 5, 39, 12)
    frag2m = frag_text(np, 2 << 20, 8192, 3, 8, 13)
    c = lz4tpu.compress
    return {
        "z9m": (c(z9m), z9m, {"sparse": 1}, True),
        "b3.5m": (c(b35), b35, {"sparse": 1}, False),
        "frag1m": (c(frag1m), frag1m, {"fused": 1}, False),
        "src1m": (c(src1m), src1m, {"dense": 1}, False),
        "frag32m": (c(frag32m), frag32m, {"fused": 1}, False),
        "frag32m-indep": (c(frag32m, block_independence=True), frag32m,
                          {"fused": 8}, False),
        "frag2m-bsum": (c(frag2m, block_checksum=True, content_size=True,
                          block_max_code=5), frag2m, {"fused": 1}, False),
        "frag2m-legacy": (c(frag2m, frame_format="legacy"), frag2m,
                          {"fused": 1}, False),
    }


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps):
    """Median of CUDA-event timings of fn() after one warm-up call.

    Each timed call is queued behind a ~1 ms spin kernel, so the start
    event fires after the host has enqueued fn's launches: a kernel's
    time is its device time, not the wrapper's Python overhead (a
    function that synchronises inside, like the plain route loops, is
    timed as it runs)."""
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


def max_abs_err(torch, a, b) -> int:
    need(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def plan_of(np, lz4tpu, tpl, data):
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu.FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, lz4tpu.FOR_ALL, data,
                                pooled_cols=True)
    stats = tpl.DecodeStats()
    plan = tpl.plan_decode(buf, parsed, table, stats)
    return buf, parsed, table, plan, stats


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_phase(torch, np, lz4tpu, tpl, corp, dev, name_card):
    """Each kernel against its plain version at main-path shapes."""
    from lz4tpu_torch.device import fused as fu
    from lz4tpu_torch.device import mxu2 as mx
    from lz4tpu_torch.device import sparse_decode as sp
    from lz4tpu_torch.device.ring import part_segments, segments_tensor

    rows = {}

    def record(name, err, ms, plain_ms):
        need(err <= TOL, f"{name}: kernel differs from plain version "
                         f"(max abs err {err})")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"[kernel] {name}: equal to plain (max_abs_err {err}, tol "
              f"{TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"[{name_card}]", flush=True)

    # H1 on frag1m: one fused chain, 556 substeps
    _buf, _p, _t, plan, _st = plan_of(np, lz4tpu, tpl, corp["frag1m"][0])
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
    record("fused_expand", max_abs_err(torch, pos_k, pos_p),
           cuda_ms(torch, lambda: fu.expand(
               t["seqrec"], t["scal"], t["patch"]), 20),
           cuda_ms(torch, lambda: fu.expand_plain(
               t["seqrec"], t["scal"], t["patch"]), 5))
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
               pos_p, lits, t["winq"], t["scal"], segs), 3))

    # H3 on src1m: one mxu2 chain, 512 substeps
    _buf, _p, _t, plan, _st = plan_of(np, lz4tpu, tpl, corp["src1m"][0])
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
           cuda_ms(torch, lambda: mx.route_plain(code, scal, segs), 3))

    # H2 on z9m: the block-fill plan's 18 blocks of 512 KiB
    _buf, _p, _t, plan, _st = plan_of(np, lz4tpu, tpl, corp["z9m"][0])
    ((_chain, prog),) = plan.sparse
    fill = sp._plan_block_fill(prog.ops, prog.n_out)
    need(fill is not None, "z9m did not plan a block fill")
    vals = torch.from_numpy(fill[0].reshape(-1)).to(dev)
    got_k = sp.block_fill(vals)
    got_p = sp.block_fill_plain(vals)
    torch.cuda.synchronize()
    record("block_fill", max_abs_err(torch, got_k, got_p),
           cuda_ms(torch, lambda: sp.block_fill(vals), 50),
           cuda_ms(torch, lambda: sp.block_fill_plain(vals), 50))
    return rows


def e2e_phase(torch, np, lz4tpu, lz4tpu_torch, tpl, _kernels, corp, dev,
              name_card):
    """The main path, corpus by corpus; returns the launch counts."""
    _kernels.reset_launches()
    for name, (data, blob, engines, fills) in corp.items():
        before = dict(_kernels.LAUNCHES)
        t0 = time.perf_counter()
        buf, _parsed, table, plan, stats = plan_of(np, lz4tpu, tpl, data)
        t1 = time.perf_counter()
        need(stats.engine_chains == engines,
             f"{name}: planned {stats.engine_chains}, expected {engines}")
        segs = tpl.build_device_segments(buf, table, plan, dev)
        out = tpl.assemble_device_segments(segs, table.n_out, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        need(out.cpu().numpy().tobytes() == blob,
             f"{name}: planned decode differs from the original")
        e2e = []
        for _ in range(3):
            s = time.perf_counter()
            res = lz4tpu_torch.decompress_to_device(data, device="cuda")
            torch.cuda.synchronize()
            e2e.append(time.perf_counter() - s)
        need(res.is_cuda and res.dtype == torch.uint8
             and res.shape == (len(blob),), f"{name}: bad result tensor")
        need(res.cpu().numpy().tobytes() == blob,
             f"{name}: decompress_to_device differs from the original")
        ran = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
        want = [k for e in engines for k in ENGINE_KERNELS.get(e, ())]
        if fills:
            want.append("block_fill")
        for k in want:
            need(ran[k] > 0, f"{name}: kernel {k} was not launched")
        e2e_s = statistics.median(e2e)
        print(f"[e2e] {name}: comp {len(data)} B -> {len(blob)} B, "
              f"engines {engines}, host prep {1e3 * (t1 - t0):.3f} ms, "
              f"device {1e3 * (t2 - t1):.3f} ms, end-to-end "
              f"{1e3 * e2e_s:.3f} ms = {len(blob) / e2e_s / 1e9:.3f} GB/s "
              f"(median of 3, verify='host'), launches {ran} "
              f"[{name_card}]", flush=True)
    return dict(_kernels.LAUNCHES)


def error_phase(lz4tpu, lz4tpu_torch, corp):
    data = bytearray(corp["frag2m-bsum"][0])
    data[300] ^= 0x20          # inside block 0, under its checksum
    data = bytes(data)
    try:
        lz4tpu.decompress_host(data)
    except lz4tpu.Lz4Error as e:
        want = e
    else:
        raise SmokeFailure("host decode accepted the corrupted frame")
    try:
        lz4tpu_torch.decompress_to_device(data, device="cuda")
    except lz4tpu_torch.Lz4Error as e:
        got = e
    else:
        raise SmokeFailure("port decoded the corrupted frame")
    need(type(got) is type(want) and str(got) == str(want),
         f"error parity: {type(got).__name__}({got}) vs "
         f"{type(want).__name__}({want})")
    print(f"[errors] corrupted block: {type(got).__name__}: {got} "
          "(same class and message as lz4tpu.decompress_host)", flush=True)


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

    import lz4tpu
    import lz4tpu_torch
    import lz4tpu_torch.pipeline as tpl
    from lz4tpu import native
    from lz4tpu_torch import _kernels

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", CUDA {torch.version.cuda}, device {kind}, "
          f"count {torch.cuda.device_count()}", flush=True)
    print(card, flush=True)

    t0 = time.perf_counter()
    _kernels.lib()
    t1 = time.perf_counter()
    need(native.available(), "native host engine failed to build")
    t2 = time.perf_counter()
    ptxas = [ln.strip() for ln in
             (_kernels.BUILD_DIR / "nvcc.log").read_text().splitlines()
             if "Used" in ln]
    print(f"[build] CUDA kernels {t1 - t0:.2f} s (nvcc, sm_90a), native "
          f"engine {t2 - t1:.2f} s", flush=True)
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)

    t0 = time.perf_counter()
    corp = corpora(np, lz4tpu)
    print(f"[corpora] {len(corp)} made and compressed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rows = kernel_phase(torch, np, lz4tpu, tpl, corp, dev, card)
    launches = e2e_phase(torch, np, lz4tpu, lz4tpu_torch, tpl, _kernels,
                         corp, dev, card)
    for name, n in launches.items():
        need(n > 0, f"kernel {name} was never launched by the main path")
    error_phase(lz4tpu, lz4tpu_torch, corp)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], **rows[name]}
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
