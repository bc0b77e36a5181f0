#!/usr/bin/env python3
"""Times of the redesigned kernels (``segment_decode``, ``fused_route``,
``fused_expand``, ``mxu2_route``, ``mxu2_route_ab``, ``block_fill``) in
two or more checkouts, in turns on one card.

Run from the root of a checkout on a machine with a GPU::

    python kernel_times.py --turns OLD_TREE NEW_TREE [MORE_TREES ...]

measures OLD, NEW, NEW, OLD (with more trees: every tree in order, then
in reverse), each in a process of its own that imports ``lz4tpu_torch``
from that tree (and builds its kernels there), and prints every time
with the card's name and power limit.  The inputs are the same for all:
the seeded corpora of the ``chip_smoke.py`` beside this script.
``--tree PATH`` measures one tree and prints one JSON object;
``--kernels a,b`` times only those kernels (the ``engines`` stage goes
with ``engines``).

Measured: ``segment_decode`` (CUDA events behind a spin kernel, median
of 5) on the shapes ``chip_smoke.segment_shapes`` names: src1m and
frag1m (one chain each), indep2m (32 chains of 64 KiB) and frag32m in
independent 64 KiB blocks (512 chains); ``fused_route`` (median of 20)
on frag1m's one chain and on frag32m-indep's 8 chains in one launch;
``fused_expand`` (median of 20) on the shapes ``chip_smoke.expand_shapes``
names (frag1m's 556 substeps, frag32m's first part of 8192);
``mxu2_route`` (median of 20, of 5 on words32m) on
``chip_smoke.route_shapes``: src1m and words32m, each one dense chain;
``mxu2_route_ab`` (median of 20): the harness kernel H7's ``exact``
variant on src1m at every substep size (the serial loop in a tree
older than the pointer-jumping H7), and, where the tree's H7 jumps
pointers, ``exact`` and ``trim`` (only the passes one decode found
work in, whose count is printed too) on words32m at every substep
size (median of 5);
``block_fill`` (median of 50) on z9m's 18 blocks of 512 KiB and on 256
blocks (128 MiB) of seeded values with high bits set (and, as the floor
under such a time, an empty launch), beside one
PyTorch copy of the same function, ``(vals & 255).to(torch.uint8)[:,
None].expand(n, 1 << 19).contiguous()`` (the library call); and the
``engines`` stage of ``decompress_to_device`` on src1m, frag32m and
frag32m-indep (host clock, synchronised, median of 5).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent


KERNELS = ("segment_decode", "fused_route", "fused_expand", "mxu2_route",
           "mxu2_route_ab", "block_fill", "engines")


def measure(tree: pathlib.Path, kernels=KERNELS) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import lz4tpu_torch as lt
    import lz4tpu_torch.pipeline as tpl
    from lz4tpu_torch.device import fused as fu
    from lz4tpu_torch.device import mxu2 as mx
    from lz4tpu_torch.device import segment_decode as sg
    from lz4tpu_torch.device import to_device
    from lz4tpu_torch.device.ring import part_segments, segments_tensor

    origin = pathlib.Path(lt.__file__).resolve().parent.parent
    if origin != tree.resolve():
        raise SystemExit(f"lz4tpu_torch came from {origin}, not {tree}")
    dev = torch.device("cuda", 0)
    out = {"tree": str(tree), "card": cs.card_line()}
    corp = cs.corpora(np, lt)

    for name, data, blob in (cs.segment_shapes(np, lt, corp)
                             if "segment_decode" in kernels else ()):
        buf, parsed, table, _plan, _st = cs.plan_of(np, lt, tpl, data)
        chains = [c for c in tpl._chains_of(table) if c.out_hi > c.out_lo]
        cols, rws = tpl._segment_tables(parsed, table, chains)
        comp = to_device(buf, dev)
        # the tables, and what else pack_chains hands to segment_decode
        # behind zero_fill (the longest chain, in a tree that sizes its
        # ring by it)
        seqs, ch, total, *rest = sg.pack_chains(cols, rws, comp.shape[0],
                                                dev)

        def run():
            return sg.segment_decode(comp, seqs, ch, total, False, *rest)

        got = run()
        torch.cuda.synchronize()
        if got.cpu().numpy().tobytes() != blob:
            raise SystemExit(f"segment_decode: {name} differs")
        out[f"segment_decode {name} ({ch.shape[0]} chains)"] = cs.cuda_ms(
            torch, run, 5)

    for name in (("frag1m", "frag32m-indep")
                 if "fused_route" in kernels else ()):
        _b, _p, _t, plan, _s = cs.plan_of(np, lt, tpl, corp[name][0])
        prep = plan.fused_prep
        n = prep.n_sub
        t = {k: to_device(np.ascontiguousarray(getattr(prep, k)[:n]), dev)
             for k in ("seqrec", "scal", "patch", "winq")}
        lits = to_device(prep.lits, dev)
        segs = segments_tensor(part_segments(prep.out_spans, 0, n, False),
                               dev)
        pos = fu.expand(t["seqrec"], t["scal"], t["patch"])
        out[f"fused_route {name} ({segs.shape[0]} chains, {n} substeps)"] = \
            cs.cuda_ms(torch, lambda: fu.route(
                pos, lits, t["winq"], t["scal"], segs), 20)
        del pos

    for name, prep, n in (cs.expand_shapes(np, lt, tpl, corp)
                          if "fused_expand" in kernels else ()):
        t = [to_device(np.ascontiguousarray(getattr(prep, k)[:n]), dev)
             for k in ("seqrec", "scal", "patch")]
        if not torch.equal(fu.expand(*t), fu.expand_plain(*t)):
            raise SystemExit(f"fused_expand: {name} differs from plain")
        out[f"fused_expand {name}"] = cs.cuda_ms(torch, lambda: fu.expand(*t),
                                                 20)

    # the wrapper is private in a tree whose H3 is pointer jumping
    route = getattr(mx, "_route", None) or mx.route
    words = (cs.words32m(np, lt) if {"mxu2_route", "mxu2_route_ab"}
             & set(kernels) else None)
    for name, pack in (cs.route_shapes(np, lt, tpl, corp, words)
                       if "mxu2_route" in kernels else ()):
        code, scal = to_device(pack.code, dev), to_device(pack.scal, dev)
        segs = segments_tensor(part_segments(pack.out_spans, 0, pack.n_sub,
                                             False), dev)
        rows, _ring = route(code, scal, segs)
        n_out = pack.out_spans[0][3]
        blob = words[1] if name.startswith("words") else corp["src1m"][1]
        if rows[:n_out].cpu().numpy().tobytes() != blob:
            raise SystemExit(f"mxu2_route: {name} differs from the original")
        del rows
        out[f"mxu2_route {name}"] = cs.cuda_ms(
            torch, lambda: route(code, scal, segs),
            5 if name.startswith("words") else 20)
        del code

    if "mxu2_route_ab" in kernels:
        from lz4tpu_torch.exp import ab

        data, blob = corp["src1m"][0], corp["src1m"][1]
        for sub in ab.SUBS:
            code = to_device(ab.pack_host(data, sub)[0], dev)
            rows, _ring = ab.route_variant(code, sub)
            if rows[:len(blob)].cpu().numpy().tobytes() != blob:
                raise SystemExit(f"mxu2_route_ab sub={sub}: src1m differs "
                                 "from the original")
            del rows
            out[f"mxu2_route_ab exact src1m, sub {sub} ({code.shape[0]} "
                "substeps)"] = cs.cuda_ms(
                    torch, lambda: ab.route_variant(code, sub), 20)
        # words32m, a text chain at its full part size: how many passes
        # find work, and what a larger substep saves there
        for sub in (ab.SUBS if hasattr(ab, "live_passes") else ()):
            code = to_device(ab.pack_host(words[0], sub)[0], dev)
            rows, _ring = ab.route_variant(code, sub)
            if rows[:len(words[1])].cpu().numpy().tobytes() != words[1]:
                raise SystemExit(f"mxu2_route_ab sub={sub}: words32m "
                                 "differs from the original")
            del rows
            n, live = code.shape[0], ab.live_passes(code, sub)
            tag = f"words32m, sub {sub} ({n} substeps"
            out[f"mxu2_route_ab exact {tag}, {mx.passes_for(n)} passes)"] = \
                cs.cuda_ms(torch, lambda: ab.route_variant(code, sub), 5)
            out[f"mxu2_route_ab trim {tag}, the live passes)"] = cs.cuda_ms(
                torch, lambda: ab.route_variant(code, sub, None, "trim",
                                                live), 5)
            out[f"passes live in one exact decode, {tag})"] = live
            del code

    if "block_fill" in kernels:
        from lz4tpu_torch import _kernels
        from lz4tpu_torch.device import sparse_decode as sp

        # the floor under any launch timed this way: one block of the
        # chain probe doing no round
        probe = cs.load_probe(torch, *cs.start_probe_build(_kernels))
        out["an empty launch (chain probe, 0 rounds)"] = cs.cuda_ms(
            torch, lambda: probe["xxh32"](0), 50)

        for name, v in cs.fill_shapes(np, lt, tpl, corp):
            vals = to_device(v, dev)
            got = sp.block_fill(vals)
            if not (torch.equal(got, sp.block_fill_plain(vals))
                    and torch.equal(got, cs.fill_library(torch, vals,
                                                      sp.FILL_BLK))):
                raise SystemExit(f"block_fill: {name} differs from plain")
            del got
            out[f"block_fill {name}"] = cs.cuda_ms(
                torch, lambda: sp.block_fill(vals), 50)
            out[f"block_fill library call {name}"] = cs.cuda_ms(
                torch, lambda: cs.fill_library(torch, vals, sp.FILL_BLK), 50)

    for name in (("src1m", "frag32m", "frag32m-indep")
                 if "engines" in kernels else ()):
        data = corp[name][0]
        cs.stages_of(torch, np, lt, tpl, data, dev, "device")
        out[f"engines stage {name}"] = statistics.median(
            cs.stages_of(torch, np, lt, tpl, data, dev, "device")["engines"]
            for _ in range(5))
    return out


def turns(trees: list, kernels: str) -> int:
    order = list(trees) + list(trees)[::-1]
    labels = (["old", "new", "new", "old"] if len(trees) == 2
              else [t.name or str(t) for t in order])
    runs = []
    for label, tree in zip(labels, order):
        r = subprocess.run(
            [sys.executable, __file__, "--tree", str(tree),
             "--kernels", kernels],
            capture_output=True, text=True, check=False)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        runs.append((label, json.loads(r.stdout.strip().splitlines()[-1])))
    card = runs[0][1]["card"]
    for key in runs[0][1]:
        # a key an older tree does not measure is left out
        if key in ("tree", "card") or any(key not in r for _l, r in runs):
            continue
        count = key.startswith("passes")
        print(f"[turns] {key}: " + ", ".join(
            f"{label} {res[key]}" if count else f"{label} {res[key]:.4f}"
            for label, res in runs)
            + f"{'' if count else ' ms'} ({', '.join(labels)}) [{card}]",
            flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=pathlib.Path)
    ap.add_argument("--turns", nargs="+", type=pathlib.Path,
                    metavar="TREE")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    args = ap.parse_args()
    if args.turns:
        if len(args.turns) < 2:
            ap.error("--turns needs two trees or more")
        return turns(args.turns, args.kernels)
    kernels = tuple(args.kernels.split(","))
    unknown = set(kernels) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    print(json.dumps(measure(args.tree or ROOT, kernels)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
