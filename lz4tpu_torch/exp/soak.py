"""Randomized differential soak of the port: fresh-seed payloads and
frame options through the host engine and every device entry point,
with random corruption and truncation held to the host engine's
outcome.  A port of the JAX package's ``exp/soak.py``; a seed draws the
same payload there and here.

    python -m lz4tpu_torch.exp.soak                 # 600 s on cuda
    python -m lz4tpu_torch.exp.soak --seconds 1200
    python -m lz4tpu_torch.exp.soak --seed S --rounds 1    # one round again
    python -m lz4tpu_torch.exp.soak --device cpu --rounds 3 --seed 0

A round (:func:`one_round`) draws a payload (:func:`payload`; in rounds
whose seed is 3 mod 4, :func:`large_payload` of 0.5-8 MiB instead) and
frame options (legacy frames, a second frame after a skippable one,
``Reservation.SINGLE_FRAME``), then checks:

* the host engine, the streaming ``Compressor`` and
  ``Decompressor.update_into`` against the payload;
* every device entry point (:func:`device_paths`) on the sound frame:
  its bytes must be the payload's;
* one flipped byte and one truncation: every device path must give
  what the host engine gives (the same bytes, or the same exception
  class and message);
* in rounds of at most 1 MiB whose seed is 0 mod 8, the device encoder
  (``compress(backend="device"|"device-emit")``), each frame decoded on
  the host and on the device.

No hidden fallback: the device entry points hand any ``Lz4Error`` to
the host engine (``pipeline._host_fallback``), which would turn a wrong
kernel byte under a checksum into the right bytes from the CPU.  Every
device call reads that function's count (``pipeline.HOST_FALLBACKS``)
before and after; where the host engine decodes the frame cleanly, one
call fails the round.

Each device call's kernel launches (``_kernels.LAUNCHES``) and the
chains each engine planned add up in a :class:`Coverage`; a timed soak
fails unless every decode kernel launched and every engine planned a
chain (:meth:`Coverage.require`).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import struct
import sys
import time

import numpy as np
import torch

from .. import _kernels, api, dist
from .. import pipeline as pl
from ..constants import FOR_ALL, SKIPPABLE_LO, Reservation
from ..errors import Lz4Error
from ..stream import Decompressor

KIB = 1024
MIB = 1024 * KIB
LEVEL10_MAX = MIB        # level 10 (the optimal parse) below this only
ENCODE_MAX = MIB         # the device-encoder leg runs on rounds this small
CPU_MAX_BYTES = 64 * KIB     # --device cpu: payloads cut to this
#: the kernels every decode path can launch (mxu2_route_ab, kernel H7,
#: is the A/B harness and launches on no decode path)
DECODE_KERNELS = ("fused_expand", "fused_route", "mxu2_route",
                  "block_fill", "xxh32_stream", "xxh32_blocks",
                  "segment_decode", "dense_codes")
#: the classifier's engines at the soak's sizes ("resolve" plans only
#: chains over pipeline._DENSE_MAX_CHAIN_OUT, 1 GiB)
ENGINES = ("sparse", "fused", "dense")


class SoakFailure(Exception):
    pass


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------

def _payload(rng: np.random.Generator) -> tuple[str, bytes]:
    """``exp/soak.py``'s payload with its kind: the same draws in the
    same order."""
    kind = rng.integers(0, 6)
    n = int(rng.integers(1, 400_000))
    if kind == 0:
        return "zeros", bytes(n)
    if kind == 1:
        return "random", rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 2:                 # fragment shuffle (text-like reuse)
        frags = [rng.integers(0, 256, int(rng.integers(4, 80)),
                              dtype=np.uint8).tobytes()
                 for _ in range(24)]
        return "fragments", b"".join(frags[int(rng.integers(0, 24))]
                                     for _ in range(n // 20 + 1))[:n]
    if kind == 3:                 # runs with period
        period = int(rng.integers(1, 300))
        pat = rng.integers(0, 256, period, dtype=np.uint8).tobytes()
        return "period", (pat * (n // period + 1))[:n]
    if kind == 4:                 # mixed zero/random stripes
        parts = []
        left = n
        while left > 0:
            k = int(rng.integers(1, 70_000))
            k = min(k, left)
            parts.append(bytes(k) if rng.integers(0, 2)
                         else rng.integers(0, 256, k, dtype=np.uint8)
                         .tobytes())
            left -= k
        return "stripes", b"".join(parts)
    return "tiny", bytes(int(rng.integers(0, 256)) for _ in range(min(n, 64)))


def payload(rng: np.random.Generator) -> bytes:
    """A payload of up to 400,000 bytes of one of six kinds, drawn as
    ``exp/soak.py`` draws it."""
    return _payload(rng)[1]


def _tokens(flat: np.ndarray, tok_len: np.ndarray, picks: np.ndarray,
            n: int) -> bytes:
    """The tokens ``picks`` (indices into ``flat``'s end-to-end tokens
    of ``tok_len`` bytes) joined, cut to ``n`` bytes."""
    tok_start = np.cumsum(tok_len) - tok_len
    out_len = tok_len[picks]
    out_start = np.cumsum(out_len) - out_len
    total = int(out_len.sum())
    idx = np.repeat(tok_start[picks] - out_start, out_len) + np.arange(total)
    return flat[idx[:n]].tobytes()


def _large_payload(rng: np.random.Generator) -> tuple[str, bytes]:
    n = int(2.0 ** rng.uniform(19, 23))          # 0.5-8 MiB, log-uniform
    kind = int(rng.integers(0, 4))
    if kind == 0:
        return "large zeros", bytes(n)
    if kind == 1:                 # zero/random stripes of 4 KiB-2 MiB
        parts, left = [], n
        while left > 0:
            k = min(left, int(2.0 ** rng.uniform(12, 21)))
            parts.append(bytes(k) if rng.integers(0, 2)
                         else rng.integers(0, 256, k, dtype=np.uint8)
                         .tobytes())
            left -= k
        return "large stripes", b"".join(parts)
    if kind == 2:                 # fragment text: short repeats (fused)
        n_frag = int(rng.integers(64, 4097))
        lens = rng.integers(3, 40, n_frag)
        flat = rng.integers(32, 127, int(lens.sum()), dtype=np.uint8)
        picks = rng.integers(0, n_frag, int(n / lens.mean() * 1.1) + 64)
        return "large fragments", _tokens(flat, lens, picks, n)
    # word text: Zipf words of 2-10 letters and separators, the text-like
    # chains that overflow the fused patch budget (mxu2)
    n_vocab = int(rng.integers(1024, 32769))
    lens = rng.integers(2, 11, n_vocab)
    seps = (b" ", b", ", b". ", b"\n")
    flat = np.concatenate([
        rng.integers(ord("a"), ord("z") + 1, int(lens.sum()), dtype=np.uint8),
        np.frombuffer(b"".join(seps), np.uint8)])
    tok_len = np.concatenate([lens, [len(s) for s in seps]])
    weight = 1.0 / np.arange(1, n_vocab + 1) ** 1.1
    cdf = np.cumsum(weight) / weight.sum()
    k = int(n / 3) + 64           # a word and a separator: >= 3 bytes
    picks = np.empty(2 * k, np.int64)
    picks[0::2] = np.minimum(np.searchsorted(cdf, rng.random(k)),
                             n_vocab - 1)
    picks[1::2] = n_vocab + rng.integers(0, len(seps), k)
    return "large words", _tokens(flat, tok_len, picks, n)


def large_payload(rng: np.random.Generator) -> bytes:
    """0.5-8 MiB (log-uniform) of zeros, zero/random stripes, fragment
    text or word text: the sizes that reach several 512 KiB fill blocks,
    hundreds of substeps, 4 MiB block edges and mxu2 chains."""
    return _large_payload(rng)[1]


def skippable(rng: np.random.Generator) -> bytes:
    """A skippable frame: magic 0x184D2A50-0x184D2A5F, a 4-byte size,
    then that many bytes."""
    size = int(rng.integers(0, 64))
    return (struct.pack("<II", SKIPPABLE_LO + int(rng.integers(0, 16)), size)
            + rng.integers(0, 256, size, dtype=np.uint8).tobytes())


# ---------------------------------------------------------------------------
# a round's draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Round:
    """Everything one seed draws: the payload, the frame and what the
    checks do to it."""

    seed: int
    kind: str
    data: bytes                 # the first frame's payload
    kw: dict                    # its options (exp/soak.py's draws)
    opts: dict                  # the extras: legacy, second frame, ...
    first: bytes                # the first frame
    frame: bytes                # all frames: what the round decodes
    expected: bytes             # what ``frame`` decodes to
    reservation: Reservation
    step: int                   # Compressor chunk
    buf_extra: int              # update_into: buffer beyond the minimum
    step2: int                  # update_into chunk
    bad: bytes | None           # one byte flipped
    flip: tuple | None          # (position, xor)
    truncated: bytes | None
    use_out: bool               # decompress_to_device(out=) this round

    def describe(self) -> str:
        return f"kind={self.kind} n={len(self.data)} kw={self.kw} {self.opts}"


def draw_round(rng: np.random.Generator, seed: int,
               max_bytes: int | None = None) -> Round:
    """Draw round ``seed``: the payload first (``exp/soak.py``'s draws
    unless the seed is 3 mod 4), cut to ``max_bytes``; then its frame
    options in ``exp/soak.py``'s order, then the extras."""
    kind, data = (_large_payload(rng) if seed % 4 == 3 else _payload(rng))
    if max_bytes is not None:
        data = data[:max_bytes]
    kw = dict(
        block_max_code=int(rng.choice([4, 5, 6, 7])),
        block_checksum=bool(rng.integers(0, 2)),
        content_checksum=bool(rng.integers(0, 2)),
        block_independence=bool(rng.integers(0, 2)),
        level=int(rng.choice([1, 4, 6, 10])),
    )
    legacy = rng.integers(0, 8) == 0
    second = rng.integers(0, 8) == 0
    skip = bool(rng.integers(0, 2)) and second
    single = rng.integers(0, 4) == 0 and not second
    if kw["level"] == 10 and len(data) >= LEVEL10_MAX:
        kw["level"] = 6
    opts = {}
    if legacy:
        opts["frame_format"] = "legacy"
        first = api.compress(data, frame_format="legacy", level=kw["level"])
    else:
        first = api.compress(data, **kw)
    frame, expected = first, data
    if second:
        kw2 = dict(block_max_code=int(rng.choice([4, 5, 6, 7])),
                   block_checksum=bool(rng.integers(0, 2)),
                   content_checksum=bool(rng.integers(0, 2)),
                   block_independence=bool(rng.integers(0, 2)),
                   level=int(rng.choice([1, 4, 6])))
        cut = int(rng.integers(0, len(data) + 1))
        if skip:
            frame += skippable(rng)
            opts["skippable"] = True
        frame += api.compress(data[cut:], **kw2)
        expected = data + data[cut:]
        opts["second"] = {"from": cut, **kw2}
    reservation = Reservation.SINGLE_FRAME if single else FOR_ALL
    if single:
        opts["reservation"] = "SINGLE_FRAME"
    step = int(rng.integers(1, max(2, len(data))))
    _ctx, consumed = Decompressor.from_header(frame, reservation)
    buf_extra = int(rng.integers(0, 4096))
    step2 = int(rng.integers(1, max(2, len(frame) - consumed)))
    bad = flip = truncated = None
    if len(frame) > 12:
        pos = int(rng.integers(4, len(frame)))
        flip = (pos, int(rng.integers(1, 256)))
        b = bytearray(frame)
        b[pos] ^= flip[1]
        bad = bytes(b)
    if len(frame) > 8:
        truncated = frame[:int(rng.integers(1, len(frame)))]
    use_out = bool(rng.integers(0, 2))
    return Round(seed, kind, data, kw, opts, first, frame, expected,
                 reservation, step, buf_extra, step2, bad, flip, truncated,
                 use_out)


# ---------------------------------------------------------------------------
# outcomes, the fallback guard, coverage
# ---------------------------------------------------------------------------

def outcome(fn, frame) -> tuple:
    """``("ok", bytes)``, ``("err", class name, message)`` for an
    ``Lz4Error``, ``("mem",)`` for a ``MemoryError``; any other
    exception is ``("raised", class name, message)``, which no host
    outcome equals."""
    try:
        return ("ok", bytes(fn(frame)))
    except Lz4Error as e:
        return ("err", type(e).__name__, str(e))
    except MemoryError:
        return ("mem",)
    except Exception as e:                  # noqa: BLE001 - reported
        return ("raised", type(e).__name__, str(e))


def _first_diff(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    x = np.frombuffer(a, np.uint8, n) != np.frombuffer(b, np.uint8, n)
    return int(np.argmax(x)) if x.any() else n


def _show(o: tuple) -> str:
    if o[0] == "ok":
        return f"ok ({len(o[1])} bytes)"
    return " ".join(map(str, o))


def differs(got: tuple, want: tuple) -> str | None:
    """Why ``got`` is not ``want``, or None."""
    if got == want:
        return None
    if got[0] == want[0] == "ok":
        return (f"bytes differ from offset {_first_diff(got[1], want[1])} "
                f"({len(got[1])} bytes against {len(want[1])})")
    return f"{_show(got)} against the host engine's {_show(want)}"


@dataclasses.dataclass
class Coverage:
    """What a soak reached, summed over its rounds."""

    rounds: int = 0
    bytes_decoded: int = 0      # device calls that returned bytes
    kinds: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    seconds: collections.Counter = dataclasses.field(   # by kind
        default_factory=collections.Counter)
    paths: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    outcomes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    chains: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    fallbacks: int = 0          # host calls on frames the host rejects
    encoded: int = 0            # device-encoder frames

    def missing(self, device: torch.device) -> list[str]:
        """What the soak has not reached: an engine that planned no
        chain, a path never called, and on the card a decode kernel
        never launched."""
        gaps = [f"engine {e} planned no chain" for e in ENGINES
                if not self.chains[e]]
        gaps += [f"path {p} never ran" for p in path_names(device)
                 if not self.paths[p]]
        if device.type == "cuda":
            gaps += [f"kernel {k} never launched" for k in DECODE_KERNELS
                     if not self.launches[k]]
        return gaps

    def require(self, device) -> None:
        gaps = self.missing(torch.device(device))
        if gaps:
            raise SoakFailure(f"the soak's {self.rounds} rounds fell short: "
                              + "; ".join(gaps))

    def lines(self) -> list[str]:
        return [
            f"[soak] {self.rounds} rounds, {self.bytes_decoded} bytes "
            f"decoded on the device paths, {self.encoded} device-encoded "
            "frames",
            "[soak] rounds by kind (seconds): " + ", ".join(
                f"{k} {n} ({self.seconds[k]:.2f})"
                for k, n in sorted(self.kinds.items())),
            f"[soak] calls by path: {dict(self.paths)}",
            "[soak] corrupted and truncated frames by outcome: "
            f"{dict(sorted(self.outcomes.items()))}; host fallbacks on "
            f"frames the host rejects: {self.fallbacks}",
            f"[soak] chains by engine: {dict(sorted(self.chains.items()))}",
            "[soak] launches by kernel: "
            + str({k: self.launches[k] for k in _kernels.LAUNCHES}),
        ]


# ---------------------------------------------------------------------------
# the device paths
# ---------------------------------------------------------------------------

def _host_bytes(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


def path_names(device: torch.device) -> list[str]:
    return [name for name, _res, _fn in device_paths(
        device, FOR_ALL, None, None, None)]


def device_paths(device: torch.device, reservation: Reservation,
                 session, mesh, stats) -> list:
    """``[(name, reservation, fn)]``: every device entry point as a
    function of the frame that returns its bytes.  The session decodes
    under its own reservation."""
    dev, res = device, reservation
    paths = []
    if dev.type == "cuda":
        paths.append(("decompress(backend='device')", res,
                      lambda f: api.decompress(f, res, backend="device")))
    paths.append(("decompress_device(engine='auto')", res,
                  lambda f: pl.decompress_device(f, res, device=dev,
                                                 stats=stats)))
    for engine in ("pallas", "resolve"):
        paths.append((f"decompress_device(engine={engine!r})", res,
                      lambda f, e=engine: pl.decompress_device(
                          f, res, e, device=dev)))
    for pipelined in (False, True):
        for verify in ("host", "device"):
            name = (f"decompress_to_device(verify={verify!r}"
                    + (", pipelined=True)" if pipelined else ")"))
            paths.append((name, res, lambda f, v=verify, p=pipelined:
                          _host_bytes(pl.decompress_to_device(
                              f, res, device=dev, verify=v, pipelined=p))))
    s_res = session.reservation if session is not None else FOR_ALL
    paths.append(("DecodeSession.result()", s_res,
                  lambda f: session.submit(f).result()))
    paths.append(("DecodeSession.result_on_device()", s_res,
                  lambda f: _host_bytes(
                      session.submit(f).result_on_device(verify="device"))))
    paths.append(("dist.decompress_sharded(4 entries)", res,
                  lambda f: dist.decompress_sharded(f, mesh, res)))
    return paths


def soak_mesh(device: torch.device) -> dist.Mesh:
    """Four entries: ``cuda:0`` four times (each its own stream) on the
    card, four CPU entries on the CPU."""
    if device.type == "cuda":
        return dist.Mesh([f"cuda:{device.index or 0}"] * 4)
    return dist.make_mesh(4, "cpu")


# ---------------------------------------------------------------------------
# one round
# ---------------------------------------------------------------------------

class _Checker:
    def __init__(self, rnd: Round, device: torch.device, cover: Coverage):
        self.rnd, self.dev, self.cover = rnd, device, cover
        self._oracle: dict = {}

    def fail(self, path: str, what: str) -> None:
        rnd = self.rnd
        cmd = f"python -m lz4tpu_torch.exp.soak --seed {rnd.seed} --rounds 1"
        if self.dev.type == "cpu":
            cmd += " --device cpu"
        raise SoakFailure(
            f"seed={rnd.seed} {rnd.describe()} path={path}: {what}\n"
            f"  repeat: {cmd}")

    def oracle(self, frame: bytes, res: Reservation) -> tuple:
        """The host engine's outcome."""
        key = (frame, res)
        if key not in self._oracle:
            self._oracle[key] = outcome(
                lambda f: api.decompress_host(f, res), frame)
        return self._oracle[key]

    def device_call(self, name: str, res: Reservation, fn, frame: bytes,
                    what: str) -> tuple:
        """Run one device path on ``frame`` and hold it to the host
        engine's outcome, with no host fallback where that is clean."""
        want = self.oracle(frame, res)
        before = dict(_kernels.LAUNCHES)
        calls = pl.HOST_FALLBACKS
        got = outcome(fn, frame)
        fell_back = pl.HOST_FALLBACKS - calls
        for k, n in _kernels.LAUNCHES.items():
            self.cover.launches[k] += n - before[k]
        self.cover.paths[name] += 1
        why = differs(got, want)
        if why is not None:
            self.fail(name, f"{what}: {why}")
        if fell_back and want[0] == "ok":
            self.fail(name, f"{what}: a sound frame fell back to the host "
                            f"({fell_back} call(s) of the host engine)")
        self.cover.fallbacks += fell_back
        if got[0] == "ok":
            self.cover.bytes_decoded += len(got[1])
        return got


def _host_legs(rnd: Round, chk: _Checker) -> None:
    """``exp/soak.py``'s host checks: the host engine, the streaming
    Compressor's frame and ``update_into``'s bytes."""
    got = outcome(lambda f: api.decompress_host(f, rnd.reservation),
                  rnd.frame)
    if got != ("ok", rnd.expected):
        chk.fail("decompress_host", differs(got, ("ok", rnd.expected)))
    if "frame_format" not in rnd.opts:      # Compressor writes modern only
        c = api.Compressor(**rnd.kw)
        out = bytearray()
        for i in range(0, len(rnd.data), rnd.step):
            out += c.update(rnd.data[i:i + rnd.step])
        out += c.finish()
        if bytes(out) != rnd.first:
            chk.fail("Compressor", f"chunks of {rnd.step}: "
                     + differs(("ok", bytes(out)), ("ok", rnd.first)))
    ctx, consumed = Decompressor.from_header(rnd.frame, rnd.reservation)
    buf = bytearray(ctx.min_buffer_size + rnd.buf_extra)
    arr = np.frombuffer(rnd.frame, np.uint8)[consumed:]
    step2, pos, stall = rnd.step2, 0, 0
    got = bytearray()
    while pos < arr.size:
        c2, first, last = ctx.update_into(arr[pos:pos + step2], buf)
        if last >= first:
            got += bytes(memoryview(buf)[first:last + 1])
        pos += c2
        if c2 == 0:
            step2 = arr.size        # stalled on a chunk boundary:
            stall += 1              # offer the whole remaining tail
            if stall >= 5:
                chk.fail("Decompressor.update_into", "stalled")
        else:
            stall = 0
    if bytes(got) != rnd.expected:
        chk.fail("Decompressor.update_into", f"chunks of {rnd.step2}: "
                 + differs(("ok", bytes(got)), ("ok", rnd.expected)))


def _out_leg(rnd: Round, chk: _Checker) -> None:
    """``decompress_to_device(out=)`` into a larger caller tensor: the
    payload lands in front, the rest is left as it was."""
    n = len(rnd.expected)
    out = torch.full((n + 4096,), 0xA5, dtype=torch.uint8, device=chk.dev)

    def into(f):
        res = pl.decompress_to_device(f, rnd.reservation, device=chk.dev,
                                      out=out)
        if res is not out:
            raise AssertionError("out= returned another tensor")
        return _host_bytes(out[:n])

    chk.device_call("decompress_to_device(out=)", rnd.reservation, into,
                    rnd.frame, "sound frame")
    if bool((out[n:] != 0xA5).any()):
        chk.fail("decompress_to_device(out=)",
                 "bytes beyond the decoded length were written")


def _encode_leg(rnd: Round, chk: _Checker, cover: Coverage) -> None:
    """The device encoder: each frame decodes to the payload on the host
    and on the device."""
    opts = {k: rnd.kw[k] for k in ("block_max_code", "block_checksum",
                                   "content_checksum", "block_independence")}
    for backend in ("device", "device-emit"):
        frame = api.compress(rnd.data, backend=backend, device=chk.dev,
                             **opts)
        name = f"compress(backend={backend!r})"
        got = chk.oracle(frame, FOR_ALL)
        if got != ("ok", rnd.data):
            chk.fail(name, "host decode: " + differs(got, ("ok", rnd.data)))
        chk.device_call(name, FOR_ALL, lambda f: _host_bytes(
            pl.decompress_to_device(f, device=chk.dev, verify="device")),
            frame, "decoded on the device")
        cover.encoded += 1


def one_round(rng: np.random.Generator, seed: int, device="cuda",
              session=None, mesh=None, *,
              cover: Coverage | None = None) -> Coverage:
    """Draw round ``seed`` from ``rng`` and check it (module docstring);
    raise :class:`SoakFailure` on the first difference.  ``session``
    (a ``DecodeSession`` on ``device``) and ``mesh`` are made for the
    round when None; on the CPU the payload is cut to
    :data:`CPU_MAX_BYTES`.  Returns ``cover`` with this round added."""
    dev = pl._resolve_device(device)
    cover = Coverage() if cover is None else cover
    t0 = time.perf_counter()
    rnd = draw_round(rng, seed,
                     CPU_MAX_BYTES if dev.type == "cpu" else None)
    own = session is None
    if own:
        from ..serve import DecodeSession

        session = DecodeSession(max_inflight=4, device=dev)
    mesh = soak_mesh(dev) if mesh is None else mesh
    try:
        chk = _Checker(rnd, dev, cover)
        _host_legs(rnd, chk)
        stats = pl.DecodeStats()
        for name, res, fn in device_paths(dev, rnd.reservation,
                                          session, mesh, stats):
            chk.device_call(name, res, fn, rnd.frame, "sound frame")
        cover.chains.update(stats.engine_chains)
        if rnd.use_out:
            _out_leg(rnd, chk)
        for what, frame in (
                (f"byte {rnd.flip and rnd.flip[0]} flipped", rnd.bad),
                ("truncated to "
                 f"{rnd.truncated and len(rnd.truncated)} bytes",
                 rnd.truncated)):
            if frame is None:
                continue
            want = chk.oracle(frame, rnd.reservation)
            cover.outcomes[want[1] if want[0] == "err" else want[0]] += 1
            for name, res, fn in device_paths(dev, rnd.reservation,
                                              session, mesh, None):
                chk.device_call(name, res, fn, frame, what)
        if len(rnd.data) <= ENCODE_MAX and seed % 8 == 0:
            _encode_leg(rnd, chk, cover)
    finally:
        if own:
            session.close()
    cover.rounds += 1
    cover.kinds[rnd.kind] += 1
    cover.seconds[rnd.kind] += time.perf_counter() - t0
    return cover


# ---------------------------------------------------------------------------
# the soak
# ---------------------------------------------------------------------------

def soak(base: int, device="cuda", *, rounds: int | None = None,
         seconds: float | None = None, progress=None) -> Coverage:
    """Rounds ``base``, ``base + 1``, ... (each from
    ``default_rng(seed)``) on one session and one four-entry mesh, until
    ``rounds`` are done or ``seconds`` have passed; ``progress(n,
    elapsed)`` after each round."""
    from ..serve import DecodeSession

    dev = pl._resolve_device(device)
    cover = Coverage()
    mesh = soak_mesh(dev)
    t0 = time.perf_counter()
    with DecodeSession(max_inflight=4, device=dev) as session:
        n = 0
        while ((rounds is None or n < rounds)
               and (seconds is None or time.perf_counter() - t0 < seconds)):
            seed = base + n
            one_round(np.random.default_rng(seed), seed, dev, session, mesh,
                      cover=cover)
            n += 1
            if progress is not None:
                progress(n, time.perf_counter() - t0)
    return cover


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4tpu_torch.exp.soak",
        description="Randomized differential soak of lz4tpu_torch's host "
                    "engine and device entry points.")
    ap.add_argument("--seconds", type=float, default=None,
                    help="run for this long (default 600 without --rounds)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="run this many rounds (coverage is reported, not "
                         "required)")
    ap.add_argument("--seed", type=int, default=None,
                    help="base seed (default: fresh from os.urandom)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu "
                         f"(payloads cut to {CPU_MAX_BYTES} bytes)")
    args = ap.parse_args(argv)
    dev = pl._resolve_device(args.device)
    seconds = args.seconds
    if seconds is None and args.rounds is None:
        seconds = 600.0
    base = (args.seed if args.seed is not None
            else int.from_bytes(os.urandom(4), "little"))
    print(f"soak: base seed {base} on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""), flush=True)
    t0 = time.perf_counter()
    last = [t0]

    def progress(n, elapsed):
        if time.perf_counter() - last[0] >= 30:
            last[0] = time.perf_counter()
            print(f"{n} rounds, {elapsed:.0f}s", flush=True)

    try:
        cover = soak(base, dev, rounds=args.rounds, seconds=seconds,
                     progress=progress)
        for line in cover.lines():
            print(line, flush=True)
        if args.rounds is None:
            cover.require(dev)
        else:
            for gap in cover.missing(dev):
                print(f"[soak] not reached: {gap}", flush=True)
    except SoakFailure as e:
        print(f"soak FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(f"soak OK: {cover.rounds} rounds in "
          f"{time.perf_counter() - t0:.0f}s (base seed {base})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
