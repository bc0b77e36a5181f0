"""A/B harness for variants of the mxu2 route kernel on the card (port
of ``exp/ab.py``): which substep size, and which phase of the pointer-
jumping route that kernel H3 (``csrc/mxu2.cu``) runs, the time is made
of.

Usage, on a machine with an NVIDIA GPU and nvcc::

    python -m lz4tpu_torch.exp.ab [spec ...]

A spec is a name of :data:`SPECS` or ``variant@sub`` (``noout@4096``).
Kernel H7 (``csrc/mxu2_ab.cu``, :func:`route_variant`) is H3's function
with the substep size as a parameter; the ring write of substep ``i``
starts at byte ``(i * sub) mod 65536`` and wraps.  Its variants: the
pointer-jumping decode (``exact``: a sources kernel, ``passes_for(n_sub)``
jump passes, an output kernel), the same decode replayed as one CUDA
graph (``graph``), the serial loop H3 was before (one SM; ``serial``,
``prefetch``), all four exact and first compared with the original
bytes; and timing-only ablations, never compared: of the jump decode
``nojump`` (no pass), ``noout`` (no output kernel), ``sources`` (the
sources kernel alone), ``trim`` and ``graphtrim`` (``exact`` and
``graph`` with only the passes that one decode found a pointer in,
:func:`live_passes`: the difference is what the empty passes cost, on
the stream and in a graph), of the serial loop one phase of its body
each.

Method: inputs staged once; ``chain`` launches in a row on one stream,
each seeded with the previous launch's ring, so they run in sequence,
queued behind a spin kernel long enough that the host has queued them
all before the card starts (else the row says ``HOST-PACED``); a
two-point slope ``(t(HI) - t(LO)) / (HI - LO)`` over CUDA events, which
cancels launch and queue costs; variants interleaved within each round;
warm-up until a round stops improving by 3%; median of the rounds with
the second-lowest and second-highest as spread.  ``AB_LO`` / ``AB_HI``
set the two chain lengths (8 and 40: a chain of the jump decode is 13
operations a decode, and a longer one would fill the launch queue).

The TPU harness's row width (``rowb``), bytes per bf16 digit (``pack``)
and select-first order (``selfirst``) shape its one-hot matmul routing
and have no counterpart on the card; their spec names map onto the
``exact`` decode of their substep size.
"""

from __future__ import annotations

import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _kernels
from ..device import to_device
from ..device.mxu2 import jump_plain, passes_for
from ..device.ring import RING, zero_ring

SUBS = (2048, 3072, 4096, 6144, 12288)
#: variant name -> the kernel's variant number (csrc/mxu2_ab.cu)
VARIANTS = {"exact": 0, "graph": 1, "nojump": 2, "noout": 3, "sources": 4,
            "trim": 0, "graphtrim": 1, "serial": 5, "prefetch": 6,
            "nogather": 7, "noring": 8, "nostore": 9, "nogather1b": 10,
            "noring1b": 11}
#: the variants whose rows are the decode
EXACT = ("exact", "graph", "serial", "prefetch")
#: the pointer-jumping variants: scratch and a number of passes
JUMP = ("exact", "graph", "nojump", "noout", "sources", "trim", "graphtrim")
#: ``exact`` and ``graph`` cut to the passes one decode found work in
TRIMMED = ("trim", "graphtrim")
_SUB_TAGS = {2048: "2k", 3072: "3k", 4096: "4k", 6144: "6k", 12288: "12k"}

#: spec name -> (sub, variant).  The first ten are the TPU harness's
#: names on the pointer-jumping decode of their substep size.
SPECS = {
    "base": (2048, "exact"), "rowb128": (2048, "exact"),
    "selfirst": (2048, "exact"), "pack3": (3072, "exact"),
    "p3r128": (3072, "exact"), "p3sf3k": (3072, "exact"),
    "sub4k": (4096, "exact"), "sf4k": (4096, "exact"),
    "p3sf6k": (6144, "exact"), "p3sf12k": (12288, "exact"),
    **{f"sub{t}": (s, "exact") for s, t in _SUB_TAGS.items()},
    **{f"graph{t}": (s, "graph") for s, t in _SUB_TAGS.items()},
    **{f"ser{t}": (s, "serial") for s, t in _SUB_TAGS.items()},
    **{f"pre{t}": (s, "prefetch") for s, t in _SUB_TAGS.items()},
    # timing only: one kernel or the empty passes of the jump decode
    # dropped, at the smallest and the largest substep
    **{f"{v}{t}": (s, v) for v in ("nojump", "noout", "sources", "trim",
                                   "graphtrim")
       for s, t in ((2048, "2k"), (12288, "12k"))},
    # timing only: one phase of the serial loop's body dropped (sub 2048)
    "nogather": (2048, "nogather"), "noring": (2048, "noring"),
    "nostore": (2048, "nostore"), "nogather1b": (2048, "nogather1b"),
    "noring1b": (2048, "noring1b"),
}
DEFAULT_SPECS = (
    *(f"{p}{t}" for p in ("sub", "graph", "ser", "pre")
      for t in _SUB_TAGS.values()),
    *(f"{v}{t}" for v in ("nojump", "noout", "sources", "trim",
                          "graphtrim") for t in ("2k", "12k")),
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


def sources_variant_plain(code: torch.Tensor, sub: int,
                          ring_in: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain version of the first kernel of H7's pointer-jumping decode:
    each code as a state word, int32 ``(n_sub * sub,)``: ``>= 0`` the
    absolute position ``i * sub + j`` of the byte it equals, ``< 0`` the
    resolved byte ``~s``.  The ring is written as one stream, so a ring
    code at offset ``o`` in substep ``i`` reads position ``i * sub - 1 -
    ((i * sub - 1 - o) mod 65536)``, or, when that is negative,
    ``ring_in[o]`` (0 without ``ring_in``)."""
    dev = code.device
    n = code.shape[0]
    before = (torch.arange(n, dtype=torch.int64, device=dev) * sub
              - 1).unsqueeze(1)
    offs = (code & 0xFFFF).to(torch.int64)
    q = before - ((before - offs) & (RING - 1))
    init = (zero_ring(dev) if ring_in is None else ring_in).to(torch.int64)
    ring_ref = ((code >> 16) & 1).bool()
    state = torch.where(ring_ref,
                        torch.where(q >= 0, q, ~init[offs]),
                        ~((code >> 17) & 255).to(torch.int64))
    return state.to(torch.int32).reshape(-1)


def route_variant_jump_plain(code: torch.Tensor, sub: int,
                             ring_in: torch.Tensor | None = None):
    """H7's pointer-jumping decode in plain PyTorch:
    :func:`sources_variant_plain`, ``mxu2.jump_plain`` for
    ``passes_for(n_sub)`` passes, then the bytes and ``ring_out`` (byte
    ``o`` from position ``n_sub * sub - 1 - ((n_sub * sub - 1 - o) mod
    65536)``, or ``ring_in[o]`` / 0 where that is negative).  Equals
    :func:`route_variant_plain`; the tests hold it there, nothing on the
    card's path calls it."""
    dev = code.device
    n = code.shape[0]
    state = jump_plain(sources_variant_plain(code, sub, ring_in),
                       passes_for(n))
    if bool((state >= 0).any()):
        raise RuntimeError("mxu2_route_ab: pointers left after every pass")
    rows = (~state).to(torch.uint8)
    last = n * sub - 1
    o = torch.arange(RING, dtype=torch.int64, device=dev)
    q = last - ((last - o) & (RING - 1))
    init = zero_ring(dev) if ring_in is None else ring_in
    ring = torch.where(q >= 0, rows[q.clamp(min=0)], init)
    return rows, ring


def _launch(code: torch.Tensor, sub: int, ring_in, variant: str,
            passes: int | None):
    """Kernel H7 on the card: ``(rows, ring_out, scratch)``; scratch is
    None for the serial variants, else the state words and then the
    ``passes + 1`` flags (flag ``p``: pass ``p + 1`` had a pointer to
    follow)."""
    n = code.shape[0]
    dev = code.device
    _kernels.check(code, "code", torch.int32, (n, sub))
    if ring_in is not None:
        _kernels.check(ring_in, "ring_in", torch.uint8, (RING,))
    rows = torch.empty(n * sub, dtype=torch.uint8, device=dev)
    ring_out = torch.empty(RING, dtype=torch.uint8, device=dev)
    scratch = None
    if variant in JUMP:
        if n * sub >= 1 << 31:
            raise ValueError(
                f"{n} substeps of {sub} bytes: positions must fit int32")
        if variant not in TRIMMED:
            passes = passes_for(n)
        # state words, the passes' flags
        scratch = torch.empty(n * sub + passes + 1, dtype=torch.int32,
                              device=dev)
    _kernels.launch(
        "mxu2_route_ab", "lz4t_mxu2_route_ab", dev,
        code.data_ptr(), n, sub, VARIANTS[variant], _kernels.ptr(ring_in),
        rows.data_ptr(), ring_out.data_ptr(), passes or 0,
        _kernels.ptr(scratch))
    return rows, ring_out, scratch


def route_variant(code: torch.Tensor, sub: int,
                  ring_in: torch.Tensor | None = None,
                  variant: str = "exact", passes: int | None = None):
    """Kernel H7: decode one chain's ``(n_sub, sub)`` codes through the
    64 KiB ring; returns ``(rows, ring_out)`` as
    :func:`route_variant_plain`.

    ``exact`` resolves every byte at once by pointer jumping (H3's
    design: a memset, ``2 + passes_for(n_sub)`` kernels, 4 B of scratch
    a byte), ``graph`` replays the same decode as one CUDA graph,
    ``serial`` and ``prefetch`` walk the substeps in order on one SM.
    The other variants are timing-only ablations whose rows are not the
    decode; those run on the card only.  Every pointer-jumping variant
    runs ``passes_for(n_sub)`` jump passes, which resolves any chain,
    except ``trim`` and ``graphtrim``: they take ``passes`` (and only
    they), the passes one decode found work in (:func:`live_passes`).
    On a CPU tensor the exact variants are :func:`route_variant_plain`."""
    if sub not in SUBS:
        raise ValueError(f"sub must be one of {SUBS}, got {sub}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if variant in TRIMMED and (passes is None or passes < 0):
        raise ValueError(f"variant {variant!r} needs passes= >= 0")
    if variant not in TRIMMED and passes is not None:
        raise ValueError(f"passes={passes} is for the trimmed variants "
                         f"{TRIMMED} only")
    if code.device.type == "cpu":
        if variant not in EXACT:
            raise ValueError(
                f"variant {variant!r} is a timing-only ablation of the "
                "CUDA kernel and has no plain version")
        return route_variant_plain(code, sub, ring_in)
    rows, ring_out, _scratch = _launch(code, sub, ring_in, variant, passes)
    return rows, ring_out


def live_passes(code: torch.Tensor, sub: int) -> int:
    """The jump passes that had a pointer to follow in one ``exact``
    decode on the card (its flags; the passes after them return at
    once).  In-place jumping may read a word another block has already
    advanced, so the count can differ from decode to decode; raises if
    pointers were left after the last pass."""
    passes = passes_for(code.shape[0])
    _rows, _ring, scratch = _launch(code, sub, None, "exact", None)
    flags = scratch[-(passes + 1):].cpu()
    if int(flags[passes]):
        raise RuntimeError("mxu2_route_ab: pointers left after every pass")
    return int(flags[:passes].count_nonzero())


#: ~1 ms of SM cycles: the spin kernel a timed chain is queued behind
SPIN_CYCLES = 2_000_000


def _timed(code: torch.Tensor, sub: int, variant: str, chain: int,
           passes: int | None, spin: int) -> tuple[float, bool]:
    """Seconds of ``chain`` launches in sequence (CUDA events), queued
    behind a spin kernel of ``spin`` cycles, and whether the host had
    queued them all before the card began the first: then the time is
    the card's alone."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    ring = None
    torch.cuda._sleep(spin)
    a.record()
    for _ in range(chain):
        _rows, ring = route_variant(code, sub, ring, variant, passes)
    b.record()
    ahead = not a.query()
    b.synchronize()
    return 1e-3 * a.elapsed_time(b), ahead


def run(data: bytes, original: bytes, specs=DEFAULT_SPECS, *, lo: int = 8,
        hi: int = 40, rounds: int = 7, device="cuda") -> list[dict]:
    """Time ``specs`` on the single-chain frame ``data`` (which decodes
    to ``original``); one dict per spec: ``name``, ``sub``, ``variant``,
    ``exact``, ``n_sub``, ``passes`` (the jump passes launched; None for
    the serial loop), ``live_passes`` (those one exact decode found work
    in), ``ms`` (per decode), ``us_per_substep``, ``gb_s``,
    ``spread_ms`` (second-lowest, second-highest), ``chain`` (the two
    chain lengths), ``ahead`` (every timed chain was queued before the
    card began it, so the times are the card's).  Raises if an exact
    variant's bytes differ from ``original``."""
    from ..pipeline import _resolve_device

    dev = _resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the harness times CUDA kernels: device='cuda'")
    if not 0 < lo < hi:
        raise ValueError(f"need 0 < lo < hi, got {lo}, {hi}")
    want = torch.from_numpy(np.frombuffer(original, np.uint8).copy())
    codes, live = {}, {}    # one pack and one count of live passes a sub
    resolved = {name: resolve_spec(name) for name in specs}
    for sub, _variant in resolved.values():
        if sub not in codes:
            code, _scal, n_out = pack_host(data, sub)
            if n_out != len(original):
                raise ValueError(
                    f"frame decodes to {n_out} bytes, original has "
                    f"{len(original)}")
            codes[sub] = to_device(code, dev)
            live[sub] = live_passes(codes[sub], sub)
    keys = list(dict.fromkeys(resolved.values()))
    passes = {k: (live[k[0]] if k[1] in TRIMMED else
                  passes_for(codes[k[0]].shape[0]) if k[1] in JUMP
                  else None) for k in keys}
    for sub, variant in keys:
        if variant in EXACT:
            rows, _ring = route_variant(codes[sub], sub, None, variant)
            if not torch.equal(rows[:len(original)].cpu(), want):
                raise RuntimeError(
                    f"mxu2_route_ab sub={sub} variant={variant}: decoded "
                    "bytes differ from the original")
    spins = dict.fromkeys(keys, SPIN_CYCLES)

    def timed(k, chain):
        return _timed(codes[k[0]], k[0], k[1], chain,
                      passes[k] if k[1] in TRIMMED else None, spins[k])

    for k in keys:      # first launches; a spin the host queues hi behind,
        for _ in range(6):  # then twice that
            if timed(k, hi)[1]:
                break
            spins[k] *= 2
        spins[k] *= 2
    t_prev = sum(timed(k, lo)[0] for k in keys)
    for _ in range(12):
        t_now = sum(timed(k, lo)[0] for k in keys)
        if t_now >= t_prev * 0.97:
            break
        t_prev = t_now
    slopes = {k: [] for k in keys}
    ahead = dict.fromkeys(keys, True)
    for _ in range(rounds):
        for k in keys:                 # interleaved: LO then HI per variant
            for _try in range(3):      # again behind a longer spin
                t_lo, a_lo = timed(k, lo)
                t_hi, a_hi = timed(k, hi)
                if a_lo and a_hi:
                    break
                spins[k] *= 2
            slopes[k].append((t_hi - t_lo) / (hi - lo))
            ahead[k] = ahead[k] and a_lo and a_hi
    out = []
    for name, key in resolved.items():
        rs = sorted(slopes[key])
        el = statistics.median(rs)
        n_sub = codes[key[0]].shape[0]
        out.append({
            "name": name, "sub": key[0], "variant": key[1],
            "exact": key[1] in EXACT, "n_sub": n_sub,
            "passes": passes[key], "live_passes": live[key[0]],
            "ms": 1e3 * el, "us_per_substep": 1e6 * el / n_sub,
            "gb_s": len(original) / el / 1e9,
            "spread_ms": (1e3 * rs[min(1, len(rs) - 1)],
                          1e3 * rs[max(-2, -len(rs))]),
            "chain": (lo, hi), "ahead": ahead[key]})
    return out


def format_row(r: dict) -> str:
    kind = "exact" if r["exact"] else "timing only"
    passes = ("serial loop" if r["passes"] is None else
              f"{r['passes']} passes, {r['live_passes']} live")
    paced = "" if r["ahead"] else "  HOST-PACED"
    return (f"{r['name']:10s} sub {r['sub']:5d} {r['variant']:10s} "
            f"({kind}, {passes}): {r['ms']:7.4f} ms  "
            f"{r['us_per_substep']:6.3f} us/substep  {r['gb_s']:6.3f} GB/s"
            f"  spread [{r['spread_ms'][0]:.4f},{r['spread_ms'][1]:.4f}]"
            f"{paced}")


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
    t0 = time.perf_counter()
    rows = run(compress(original), original, specs,
               lo=int(os.environ.get("AB_LO", "8")),
               hi=int(os.environ.get("AB_HI", "40")))
    print(f"per-decode medians ({len(original)} bytes of source text, "
          f"{card_line()}; {time.perf_counter() - t0:.1f} s):")
    for r in rows:
        print("  " + format_row(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
