"""A/B harness for variants of the mxu2 route kernel on the card (port
of ``exp/ab.py``): which substep size, and which phase of the loop, the
time of kernel H3 (``csrc/mxu2.cu``) is made of.

Usage, on a machine with an NVIDIA GPU and nvcc::

    python -m lz4tpu_torch.exp.ab [spec ...]

A spec is a name of :data:`SPECS` or ``variant@sub`` (``noring@4096``).
Kernel H7 (``csrc/mxu2_ab.cu``, :func:`route_variant`) is H3's function
with the substep size as a parameter; the ring write of substep ``i``
starts at byte ``(i * sub) mod 65536`` and wraps.  Exact variants
(``exact``, ``prefetch``) are first compared with the original bytes;
the phase ablations are timing-only and never compared.

Method: inputs staged once; ``chain`` launches in a row on one stream,
each seeded with the previous launch's ring, so they run in sequence; a
two-point slope ``(t(HI) - t(LO)) / (HI - LO)`` over CUDA events, which
cancels launch and queue costs; variants interleaved within each round;
warm-up until a round stops improving by 3%; median of the rounds with
the second-lowest and second-highest as spread.  ``AB_LO`` / ``AB_HI``
set the two chain lengths.

The TPU harness's row width (``rowb``), bytes per bf16 digit (``pack``)
and select-first order (``selfirst``) shape its one-hot matmul routing
and have no counterpart on the card; their spec names map onto the
variant of their substep size.
"""

from __future__ import annotations

import os
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

from .. import _kernels
from ..device import to_device
from ..device.ring import RING, zero_ring

SUBS = (2048, 3072, 4096, 6144, 12288)
#: variant name -> the kernel's variant number (csrc/mxu2_ab.cu)
VARIANTS = {"exact": 0, "prefetch": 1, "nogather": 2, "noring": 3,
            "nostore": 4, "nogather1b": 5, "noring1b": 6}
EXACT = ("exact", "prefetch")

#: spec name -> (sub, variant).  The first ten are the TPU harness's
#: names on the Hopper variant of their substep size.
SPECS = {
    "base": (2048, "exact"), "rowb128": (2048, "exact"),
    "selfirst": (2048, "exact"), "pack3": (3072, "exact"),
    "p3r128": (3072, "exact"), "p3sf3k": (3072, "exact"),
    "sub4k": (4096, "exact"), "sf4k": (4096, "exact"),
    "p3sf6k": (6144, "exact"), "p3sf12k": (12288, "exact"),
    "sub2k": (2048, "exact"), "sub3k": (3072, "exact"),
    "sub6k": (6144, "exact"), "sub12k": (12288, "exact"),
    "pre2k": (2048, "prefetch"), "pre3k": (3072, "prefetch"),
    "pre4k": (4096, "prefetch"), "pre6k": (6144, "prefetch"),
    "pre12k": (12288, "prefetch"),
    # timing only: one phase of H3's loop body dropped (sub 2048)
    "nogather": (2048, "nogather"), "noring": (2048, "noring"),
    "nostore": (2048, "nostore"), "nogather1b": (2048, "nogather1b"),
    "noring1b": (2048, "noring1b"),
}
DEFAULT_SPECS = ("sub2k", "sub3k", "sub4k", "sub6k", "sub12k",
                 "pre2k", "pre3k", "pre4k", "pre6k", "pre12k",
                 "nogather", "noring", "nostore", "nogather1b", "noring1b")


def resolve_spec(name: str) -> tuple[int, str]:
    """``(sub, variant)`` of a spec name or of ``variant@sub``."""
    if name in SPECS:
        return SPECS[name]
    variant, _, sub = name.partition("@")
    if variant in VARIANTS and sub.isdigit() and int(sub) in SUBS:
        return int(sub), variant
    raise ValueError(f"unknown variant spec {name!r}")


def pack_host(data: bytes, sub: int):
    """Per-byte routing codes of the single chain in LZ4 frame ``data``
    at substep size ``sub`` (numpy; the mxu2 packer's rules): a literal
    is a known byte (``value << 17``); a reference that reaches before
    its substep's base is a ring code (``(src & 0xFFFF) | 1 << 16``); a
    reference inside its substep takes the code of the byte it resolves
    to (pointer doubling).  Returns ``(code int32 (n_sub, sub), scal
    int32 (n_sub, 1), n_out)``; ``scal`` is the ring row (of 256 bytes)
    each substep is written at."""
    from ..constants import FOR_ALL
    from ..frame import parse_frames
    from ..pipeline import build_seq_table

    buf = np.frombuffer(data, np.uint8)
    t = build_seq_table(buf, parse_frames(buf, FOR_ALL), FOR_ALL, data)
    ll = t.lit_len.astype(np.int64)
    ls = t.lit_src.astype(np.int64)
    ml = t.match_len.astype(np.int64)
    mo = t.match_off.astype(np.int64)
    sizes = ll + ml
    n_out = int(sizes.sum())
    starts = np.zeros(sizes.size, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    seq = np.repeat(np.arange(sizes.size), sizes)
    j = np.arange(n_out, dtype=np.int64)
    local = j - starts[seq]
    is_lit = local < ll[seq]
    litval = buf[np.where(is_lit, ls[seq] + local, 0)].astype(np.int64)
    src = j - mo[seq]
    fixed = is_lit | (src < (j // sub) * sub)
    h = np.where(fixed, j, src)
    k = 1
    while k < sub:
        h = h[h]
        k <<= 1
    code = np.where(
        is_lit[h], litval[h] << 17, (src[h] & 0xFFFF) | (1 << 16)
    ).astype(np.int32)
    n_sub = -(-n_out // sub)
    flat = np.zeros(n_sub * sub, np.int32)
    flat[:n_out] = code
    scal = ((np.arange(n_sub, dtype=np.int32) * (sub // 256)) % 256
            ).reshape(n_sub, 1)
    return flat.reshape(n_sub, sub), scal, n_out


def route_variant_plain(code: torch.Tensor, sub: int,
                        ring_in: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`route_variant` (exact variants):
    a serial substep loop with the wrapping ring write.  Returns
    ``(rows uint8 (n_sub * sub,), ring_out uint8 (65536,))``."""
    dev = code.device
    n = code.shape[0]
    rows = torch.zeros(n * sub, dtype=torch.uint8, device=dev)
    is_ring = ((code >> 16) & 1).bool()
    src = (code & 0xFFFF).to(torch.int64)
    known = ((code >> 17) & 255).to(torch.uint8)
    ring = zero_ring(dev) if ring_in is None else ring_in.clone()
    at = torch.arange(sub, dtype=torch.int64, device=dev)
    for i in range(n):
        vals = torch.where(is_ring[i], ring[src[i]], known[i])
        rows[i * sub:(i + 1) * sub] = vals
        ring[(i * sub + at) & (RING - 1)] = vals
    return rows, ring


def route_variant(code: torch.Tensor, sub: int,
                  ring_in: torch.Tensor | None = None,
                  variant: str = "exact"):
    """Kernel H7: decode one chain's ``(n_sub, sub)`` codes through the
    64 KiB ring; returns ``(rows, ring_out)`` as
    :func:`route_variant_plain`.  ``variant`` other than ``exact`` and
    ``prefetch`` is a timing-only ablation whose rows are not the
    decode; those run on the card only."""
    if sub not in SUBS:
        raise ValueError(f"sub must be one of {SUBS}, got {sub}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if code.device.type == "cpu":
        if variant not in EXACT:
            raise ValueError(
                f"variant {variant!r} is a timing-only ablation of the "
                "CUDA kernel and has no plain version")
        return route_variant_plain(code, sub, ring_in)
    n = code.shape[0]
    dev = code.device
    _kernels.check(code, "code", torch.int32, (n, sub))
    if ring_in is not None:
        _kernels.check(ring_in, "ring_in", torch.uint8, (RING,))
    rows = torch.empty(n * sub, dtype=torch.uint8, device=dev)
    ring_out = torch.empty(RING, dtype=torch.uint8, device=dev)
    _kernels.launch(
        "mxu2_route_ab", "lz4t_mxu2_route_ab", dev,
        code.data_ptr(), n, sub, VARIANTS[variant], _kernels.ptr(ring_in),
        rows.data_ptr(), ring_out.data_ptr())
    return rows, ring_out


def _timed(code: torch.Tensor, sub: int, variant: str, chain: int) -> float:
    """Seconds of ``chain`` launches in sequence (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ring = None
    a.record()
    for _ in range(chain):
        _rows, ring = route_variant(code, sub, ring, variant)
    b.record()
    b.synchronize()
    return 1e-3 * a.elapsed_time(b)


def run(data: bytes, original: bytes, specs=DEFAULT_SPECS, *, lo: int = 64,
        hi: int = 320, rounds: int = 7, device="cuda") -> list[dict]:
    """Time ``specs`` on the single-chain frame ``data`` (which decodes
    to ``original``); one dict per spec: ``name``, ``sub``, ``variant``,
    ``exact``, ``n_sub``, ``ms`` (per decode), ``us_per_substep``,
    ``gb_s``, ``spread_ms`` (second-lowest, second-highest), ``chain``
    (the two chain lengths).  Raises if an exact variant's bytes differ
    from ``original``."""
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the harness times CUDA kernels: device='cuda'")
    if not 0 < lo < hi:
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    want = torch.from_numpy(np.frombuffer(original, np.uint8).copy())
    staged = {}     # (sub, variant) -> code on the card; one pack per sub
    codes = {}
    resolved = {name: resolve_spec(name) for name in specs}
    for sub, variant in resolved.values():
        if sub not in codes:
            code, _scal, n_out = pack_host(data, sub)
            if n_out != len(original):
                raise ValueError(
                    f"frame decodes to {n_out} bytes, original has "
                    f"{len(original)}")
            codes[sub] = to_device(code, dev)
        staged[(sub, variant)] = codes[sub]
    for (sub, variant), code in staged.items():
        if variant in EXACT:
            rows, _ring = route_variant(code, sub, None, variant)
            if not torch.equal(rows[:len(original)].cpu(), want):
                raise RuntimeError(
                    f"mxu2_route_ab sub={sub} variant={variant}: decoded "
                    "bytes differ from the original")
    keys = list(staged)

    def round_of(chain):
        return {k: _timed(staged[k], k[0], k[1], chain) for k in keys}

    round_of(hi)                       # build, first launches, clocks
    t_prev = sum(round_of(lo).values())
    for _ in range(12):
        t_now = sum(round_of(lo).values())
        if t_now >= t_prev * 0.97:
            break
        t_prev = t_now
    slopes = {k: [] for k in keys}
    for _ in range(rounds):
        for k in keys:                 # interleaved: LO then HI per variant
            t_lo = _timed(staged[k], k[0], k[1], lo)
            t_hi = _timed(staged[k], k[0], k[1], hi)
            slopes[k].append((t_hi - t_lo) / (hi - lo))
    out = []
    for name, key in resolved.items():
        rs = sorted(slopes[key])
        el = statistics.median(rs)
        n_sub = staged[key].shape[0]
        out.append({
            "name": name, "sub": key[0], "variant": key[1],
            "exact": key[1] in EXACT, "n_sub": n_sub, "ms": 1e3 * el,
            "us_per_substep": 1e6 * el / n_sub,
            "gb_s": len(original) / el / 1e9,
            "spread_ms": (1e3 * rs[min(1, len(rs) - 1)],
                          1e3 * rs[max(-2, -len(rs))]),
            "chain": (lo, hi)})
    return out


def format_row(r: dict) -> str:
    kind = "exact" if r["exact"] else "timing only"
    return (f"{r['name']:10s} sub {r['sub']:5d} {r['variant']:10s} "
            f"({kind}): {r['ms']:7.4f} ms  {r['us_per_substep']:6.3f} "
            f"us/substep  {r['gb_s']:6.3f} GB/s  spread "
            f"[{r['spread_ms'][0]:.4f},{r['spread_ms'][1]:.4f}]")


def package_text(n: int) -> bytes:
    """``n`` bytes of this package's own source text (sorted paths,
    repeated when shorter: the repeats lie beyond LZ4's 64 KiB window)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    blob = b"".join(p.read_bytes() for p in sorted(root.rglob("*"))
                    if p.suffix in (".py", ".cpp", ".cu", ".cuh"))
    return (blob * (n // len(blob) + 1))[:n]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    from ..api import compress

    specs = tuple(sys.argv[1:] if argv is None else argv) or DEFAULT_SPECS
    original = package_text(1 << 20)
    rows = run(compress(original), original, specs,
               lo=int(os.environ.get("AB_LO", "64")),
               hi=int(os.environ.get("AB_HI", "320")))
    print(f"per-decode medians ({len(original)} bytes of source text, "
          f"{card_line()}):")
    for r in rows:
        print("  " + format_row(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
