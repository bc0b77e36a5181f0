"""The bench's inputs: seeded corpora, the two frame configurations,
the five cells' requests, and the record that pins each cell's
compressed input.

Every corpus is made from ``--seed`` with ``numpy.random.default_rng``;
no file is read, so the inputs do not move when the code's text does.
The encoder does move them: a cell's requests are compressed with
:func:`lz4tpu_torch.compress` under its configuration's flags, so each
cell's compressed bytes are recorded here (:data:`RECORDED`) and a cell
whose input no longer matches is refused.  Changing a record is a
change of the benchmark.

``python -m bench_torch.corpora [--seed N]`` makes every cell's input on
the host, checks its engine mix, and prints the record of that seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys

import numpy as np

import lz4tpu_torch as lt
from lz4tpu_torch import pipeline as pl

MiB = 1 << 20
DEFAULT_SEED = 1

#: Frame flags of each configuration, for :func:`lz4tpu_torch.compress`.
#: Both are decoded with ``verify="device"``: every checksum a frame
#: carries is checked on the card.
CONFIGS = {
    # lz4 programs/lz4.1: defaults of -B# (7: 4 MiB), -BD (off:
    # independent blocks) and --[no-]frame-crc (on); no block checksum,
    # no content size
    "lz4cli-default": dict(block_max_code=7, block_independence=True,
                           content_checksum=True, block_checksum=False,
                           content_size=False),
    # lz4frame.h: LZ4F_blockLinked, the frame library's default block
    # mode, at 4 MiB blocks; lz4tpu_torch.compress's own defaults
    "lz4f-linked": dict(block_max_code=7, block_independence=False,
                        content_checksum=True, block_checksum=False,
                        content_size=False),
}
BLOCK = 4 * MiB

#: The engine that plans each corpus kind's chains.
ENGINE = {"words": "dense", "frag": "fused", "zeros": "sparse",
          "urandom": "sparse"}
#: The engines a session request of each kind may plan as: a fragment
#: slice's independent block can overflow the fused budgets (the
#: literal window starts empty in every block) and goes to the mxu2
#: engine, as in any decode.
SESSION_ENGINES = {"words": {"dense"}, "frag": {"fused", "dense"},
                   "zeros": {"sparse"}, "urandom": {"sparse"}}

# one stream of the seed's generator per use, so that a change to one
# corpus leaves the others as they were
_STREAM = {"words": 0, "frag": 1, "urandom": 2, "session": 3}

# session-mix's traffic is chosen, not taken from a source: the mix,
# the sizes and the requests a round (max_inflight=4 is DecodeSession's
# default).  Its cell says so in ``source``.
SESSION_REQUESTS = 24
SESSION_MIX = {"words": 0.50, "frag": 0.25, "zeros": 0.15, "urandom": 0.10}


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    kinds: tuple        # corpus kinds of its requests, in request order
    size: int           # decoded bytes of a request (the largest one)
    traffic: str
    source: str         # where the configuration and the shapes come from


_LINKED = "lz4frame.h LZ4F_blockLinked at lz4 programs/lz4.1's -B7"
_CLI = "lz4 programs/lz4.1 defaults (-B7, -BD off, --frame-crc)"
_WORDS = ("seeded Zipf words; vocabulary and exponent chosen (no text "
          "corpus in the repository)")

CELLS = (
    Cell("words32m-linked", "lz4f-linked", ("words",), 32 * MiB,
         "closed loop, 1 client: one 32 MiB words request at a time",
         f"config: {_LINKED}; corpus: {_WORDS}"),
    Cell("words32m-cli", "lz4cli-default", ("words",), 32 * MiB,
         "closed loop, 1 client: one 32 MiB words request at a time, "
         "8 independent blocks",
         f"config: {_CLI}; corpus: {_WORDS}"),
    Cell("frag32m-linked", "lz4f-linked", ("frag",), 32 * MiB,
         "closed loop, 1 client: one 32 MiB fragment-text request at a "
         "time",
         f"config: {_LINKED}; corpus: 2048 seeded fragments of 5-39 B, "
         "chosen to stay in the fused engine"),
    Cell("refbench-256m", "lz4cli-default", ("zeros", "urandom"),
         256 * MiB,
         "closed loop, 1 client: zeros and urandom requests of 256 MiB "
         "in turns",
         f"config: {_CLI}; corpus: the reference's test_benchmark.sh:6-20 "
         "zeroes and urandom, 2 GiB reduced to 256 MiB"),
    Cell("session-mix", "lz4cli-default", tuple(SESSION_MIX), 32 * MiB,
         "DecodeSession(max_inflight=4), 4 in flight, 24 requests a round "
         "of 1-32 MiB (log-uniform): 50% words, 25% frag, 15% zeros, "
         "10% urandom",
         f"config: {_CLI}; traffic: unsourced (mix, sizes and requests a "
         "round chosen); not for BENCHMARK.json until sourced"),
)
CELL = {c.name: c for c in CELLS}

#: seed -> cell -> (compressed bytes, SHA-256 of the requests'
#: compressed bytes laid end to end in request order), made by
#: ``python -m bench_torch.corpora --seed N``.
RECORDED = {
    1: {
        "words32m-linked": (14597155, "e15fe04c4f4db221ae3bca45c4f6a7da"
                                      "3498035913209e36d3463c83a593fdb8"),
        "words32m-cli": (14621774, "a27414174b09f8c9f90040ae520ff709"
                                   "d383f7fc24b682b2e7b6962ad5799525"),
        "frag32m-linked": (12149144, "9dfeff3ba46951ed15645ffd00a0ca08"
                                     "f6a149fbe379c7371e38dd02705b562e"),
        "refbench-256m": (269489374, "24117d8d2372f82f077aa9263ccf08d9"
                                     "85a6977793900073d6bb50b3077467ce"),
        "session-mix": (68564894, "d830964d803ee073e4c490a9f8c4245d"
                                  "82720787916ab891ed31f2b45a252ad1"),
    },
    # a second seed, for a claim that must also hold on inputs the
    # change was not written against
    2: {
        "words32m-linked": (14582914, "ccda7687e7440a24afb74409e3766cdb"
                                      "187bd94fb28dea6b2a4347fd50ba2579"),
        "words32m-cli": (14607565, "e1c9756f3aca0f2b4f28175a4dcd10ba"
                                   "3f53a89729235e4349317861171d3306"),
        "frag32m-linked": (12223301, "7abde36b407b83a4c1ffd90e67ee7ecf"
                                     "72ae1af46d5974b4c42bfe91e5228b34"),
        "refbench-256m": (269489374, "fa675ae0fab55c381c63dbb803df1e59"
                                     "fe9317569e2096e338027b0fef9ae35b"),
        "session-mix": (122157569, "7b1fff43f3abfe3dc7042baa53c7c2c0"
                                   "f37e2cc353d913e8781cf1f518601a47"),
    },
}


class InputChanged(Exception):
    """A cell's compressed input is not the recorded one."""


@dataclasses.dataclass
class Request:
    kind: str
    comp: bytes
    orig: bytes
    engines: dict | None    # the engine mix plan_decode must give;
    #                         None for a session request (check_engines)


def _rng(seed: int, use: str) -> np.random.Generator:
    return np.random.default_rng([seed, _STREAM[use]])


def words_text(n: int, seed: int) -> bytes:
    """n bytes of Zipf word text: a vocabulary of 32,768 words of 2-10
    letters a-z, drawn with exponent 1.1, each word followed by one of
    ``" "``, ``", "``, ``". "`` or ``"\\n"`` (uniformly)."""
    rng = _rng(seed, "words")
    n_vocab = 32768
    lens = rng.integers(2, 11, n_vocab)
    letters = rng.integers(ord("a"), ord("z") + 1, int(lens.sum()),
                           dtype=np.uint8)
    seps = (b" ", b", ", b". ", b"\n")
    flat = np.concatenate([letters,
                           np.frombuffer(b"".join(seps), np.uint8)])
    tok_len = np.concatenate([lens, [len(s) for s in seps]])
    tok_start = np.cumsum(tok_len) - tok_len
    weight = 1.0 / np.arange(1, n_vocab + 1) ** 1.1
    cdf = np.cumsum(weight) / weight.sum()
    mean = (weight / weight.sum() * lens).sum() + 1.5
    k = int(n / mean * 1.05) + 64
    seq = np.empty(2 * k, np.int64)
    seq[0::2] = np.minimum(np.searchsorted(cdf, rng.random(k)), n_vocab - 1)
    seq[1::2] = n_vocab + rng.integers(0, len(seps), k)
    out_len = tok_len[seq]
    total = int(out_len.sum())
    if total < n:
        raise RuntimeError("word corpus came out short")
    out_start = np.cumsum(out_len) - out_len
    idx = np.repeat(tok_start[seq] - out_start, out_len) + np.arange(total)
    return flat[idx[:n]].tobytes()


def frag_text(n: int, seed: int) -> bytes:
    """n bytes drawn uniformly from 2048 printable fragments of 5-39
    bytes: short repeats that stay in the fused engine."""
    n_frag, lo, hi = 2048, 5, 39
    rng = _rng(seed, "frag")
    frags = [rng.integers(32, 127, int(rng.integers(lo, hi + 1)),
                          dtype=np.uint8).tobytes() for _ in range(n_frag)]
    mean = np.mean([len(f) for f in frags])
    picks = rng.integers(0, n_frag, int(n / mean * 1.1) + 16)
    out = b"".join(frags[i] for i in picks)
    if len(out) < n:
        raise RuntimeError("fragment corpus came out short")
    return out[:n]


def corpus(kind: str, n: int, seed: int) -> bytes:
    if kind == "words":
        return words_text(n, seed)
    if kind == "frag":
        return frag_text(n, seed)
    if kind == "zeros":
        return bytes(n)
    if kind == "urandom":
        return _rng(seed, "urandom").bytes(n)
    raise ValueError(f"unknown corpus kind {kind!r}")


def n_chains(config: str, n: int) -> int:
    """Chains of an ``n``-byte frame: one for linked blocks, one a block
    for independent ones."""
    return -(-n // BLOCK) if CONFIGS[config]["block_independence"] else 1


def expected_engines(kind: str, config: str, n: int) -> dict:
    """The engine mix of ``n`` bytes of ``kind`` under ``config``."""
    return {ENGINE[kind]: n_chains(config, n)}


def _session_draws(seed: int, size: int):
    """``SESSION_REQUESTS`` draws of (kind, offset, length): lengths
    log-uniform over size/32 .. size, at an offset uniform over the
    kind's corpus of ``size`` bytes."""
    rng = _rng(seed, "session")
    kinds = list(SESSION_MIX)
    picks = rng.choice(len(kinds), SESSION_REQUESTS,
                       p=list(SESSION_MIX.values()))
    lengths = np.exp2(rng.uniform(np.log2(size / 32), np.log2(size),
                                  SESSION_REQUESTS)).astype(np.int64)
    offsets = rng.integers(0, size - lengths + 1)
    return [(kinds[k], int(o), int(n))
            for k, o, n in zip(picks, offsets, lengths)]


def cell_requests(cell: Cell, seed: int, size: int | None = None) -> list:
    """The cell's distinct requests, in the order its loop sends them.
    ``size`` replaces the cell's request size (small rehearsals)."""
    size = cell.size if size is None else size
    flags = CONFIGS[cell.config]

    def request(kind, orig, engines):
        return Request(kind, lt.compress(orig, **flags), orig, engines)

    if cell.name != "session-mix":
        return [request(kind, orig,
                        expected_engines(kind, cell.config, size))
                for kind in cell.kinds
                for orig in (corpus(kind, size, seed),)]
    draws = _session_draws(seed, size)
    base = {kind: corpus(kind, size, seed)
            for kind in sorted({k for k, _o, _n in draws})}
    return [request(kind, base[kind][off:off + n], None)
            for kind, off, n in draws]


def digest(requests) -> tuple:
    """(compressed bytes, SHA-256 of the compressed requests end to end)."""
    h = hashlib.sha256()
    for r in requests:
        h.update(r.comp)
    return sum(len(r.comp) for r in requests), h.hexdigest()


def check_record(cell: Cell, seed: int, requests) -> tuple:
    """Refuse a cell whose compressed input is not the one recorded for
    ``seed``; returns the digest."""
    got = digest(requests)
    want = RECORDED.get(seed, {}).get(cell.name)
    if want is None:
        raise InputChanged(
            f"{cell.name}: no recorded input for seed {seed} (recorded "
            f"seeds: {sorted(RECORDED)})")
    if tuple(want) != got:
        raise InputChanged(
            f"{cell.name}: compressed input {got[0]} B sha256 {got[1]} is "
            f"not the recorded {want[0]} B sha256 {want[1]} (seed {seed}): "
            "the encoder's output changed")
    return got


def engine_mix(comp: bytes) -> dict:
    """plan_decode's engine mix of one frame, on the host."""
    buf = np.frombuffer(comp, np.uint8)
    parsed = pl.parse_frames(buf, lt.FOR_ALL)
    table = pl.build_seq_table(buf, parsed, lt.FOR_ALL, comp,
                               pooled_cols=True)
    stats = pl.DecodeStats()
    pl.plan_decode(buf, parsed, table, stats)
    return stats.engine_chains


def check_engines(cell: Cell, requests, mixes) -> None:
    """Assert every request's engine mix (``mixes``, from
    :func:`engine_mix`): the cell's own for a single-request cell; for a
    session request, its kind's engines over as many chains as the
    frame has."""
    for i, (r, got) in enumerate(zip(requests, mixes)):
        if r.engines is not None:
            ok = got == r.engines
            want = r.engines
        else:
            want = (f"{sorted(SESSION_ENGINES[r.kind])} over "
                    f"{n_chains(cell.config, len(r.orig))} chains")
            ok = (set(got) <= SESSION_ENGINES[r.kind] and sum(got.values())
                  == n_chains(cell.config, len(r.orig)))
        if not ok:
            raise InputChanged(
                f"{cell.name}: request {i} ({r.kind}, {len(r.orig)} B) "
                f"plans as {got}, expected {want}")


def total_mix(mixes) -> dict:
    total: dict = {}
    for mix in mixes:
        for k, v in mix.items():
            total[k] = total.get(k, 0) + v
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bench_torch.corpora",
        description="Make every cell's input on the host, check its "
                    "engine mix, and print the record of the seed.")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    args = ap.parse_args(argv)
    record = {}
    for cell in CELLS:
        requests = cell_requests(cell, args.seed)
        mixes = [engine_mix(r.comp) for r in requests]
        check_engines(cell, requests, mixes)
        record[cell.name] = list(digest(requests))
        print(f"{cell.name}: {len(requests)} request(s), "
              f"{sum(len(r.orig) for r in requests)} B -> "
              f"{record[cell.name][0]} B, engines {total_mix(mixes)}",
              file=sys.stderr)
        del requests
    print(json.dumps({args.seed: record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
