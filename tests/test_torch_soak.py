"""lz4tpu_torch.exp.soak on the CPU: its payloads are the JAX package's
soak's draw for draw, its rounds pass through every device entry point
(``device="cpu"``: the plain versions of the kernels), its corrupted and
truncated frames give the same outcome from both packages' host engines
and the port's device pipeline, and its guard sees a wrong kernel byte
that the host fallback would hide.  The faults the soak found are pinned
here, each by the frame of the seed that found it.  Payloads stay at or
under 64 KiB (the soak's cut on the CPU; the plain H4 costs ~0.1 ms a
16-byte stripe) except the sharded fault's 398,447 bytes, whose size is
the fault.  Tolerance 0.
"""

import ast
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.frame as jframe
import lz4tpu_torch as lt
import lz4tpu_torch.pipeline as tpl
from lz4tpu.serve import DecodeSession as JaxSession
from lz4tpu_torch import dist
from lz4tpu_torch.device import mxu2 as tmx
from lz4tpu_torch.exp import soak
from lz4tpu_torch.serve import DecodeSession

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _jax_soak():
    spec = importlib.util.spec_from_file_location(
        "_jax_soak", REPO / "exp" / "soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_outcome(fn, frame) -> tuple:
    try:
        return ("ok", bytes(fn(frame)))
    except lz4tpu.errors.Lz4Error as e:
        return ("err", type(e).__name__, str(e))
    except MemoryError:
        return ("mem",)


@pytest.mark.parametrize("seed", range(32))
def test_payload_equals_the_jax_soaks(seed):
    want = _jax_soak().payload(np.random.default_rng(seed))
    assert soak.payload(np.random.default_rng(seed)) == want


def test_rounds_draw_the_jax_soaks_payload_unless_large():
    """A round draws its payload first: exp/soak.py's, except in rounds
    whose seed is 3 mod 4 (chosen by the seed, not drawn)."""
    jax_soak = _jax_soak()
    for seed in range(24):
        rnd = soak.draw_round(np.random.default_rng(seed), seed, 4096)
        want = jax_soak.payload(np.random.default_rng(seed))[:4096]
        assert rnd.kind.startswith("large") == (seed % 4 == 3), seed
        if seed % 4 != 3:
            assert rnd.data == want, seed


def test_large_payloads_reach_their_engines():
    """Sizes are 0.5-8 MiB; word text plans an mxu2 chain, fragment text
    a fused one and zeros a block-fill sparse program (cut to 1 MiB)."""
    seen = {}
    for s in range(64):
        kind, data = soak._large_payload(np.random.default_rng(s))
        assert 1 << 19 <= len(data) < 1 << 23, (s, len(data))
        seen.setdefault(kind, data[:1 << 20])
    assert set(seen) == {"large zeros", "large stripes", "large fragments",
                         "large words"}
    for kind, engine in (("large words", "dense"),
                         ("large fragments", "fused"),
                         ("large zeros", "sparse")):
        data = lt.compress(seen[kind], level=1)
        buf = np.frombuffer(data, np.uint8)
        parsed = tpl.parse_frames(buf, lt.FOR_ALL)
        table = tpl.build_seq_table(buf, parsed, lt.FOR_ALL, data)
        st = tpl.DecodeStats()
        plan = tpl.plan_decode(buf, parsed, table, st)
        assert st.engine_chains == {engine: 1}, kind
    assert any(op.kind == "fill" for op in plan.sparse[0][1].ops)


#: name -> seed: what each round is pinned below (cut to 64 KiB on
#: the CPU, as the soak cuts it there)
ROUNDS = {
    "tiny-checksums-encoder": 0,
    "fragments-single-frame": 1,
    "stripes-second-frame": 5,
    "large-words-legacy": 11,
    "legacy-skippable-second": 13,
    "period-dense-encoder": 16,
    "large-stripes-skippable-second": 31,
    "large-words-skippable-second": 35,
    "large-fragments-64k": 15,
}


def _round(seed):
    return soak.draw_round(np.random.default_rng(seed), seed,
                           soak.CPU_MAX_BYTES)


def test_rounds_are_what_their_names_say():
    r = {name: _round(seed) for name, seed in ROUNDS.items()}
    assert r["tiny-checksums-encoder"].kind == "tiny"
    assert r["fragments-single-frame"].opts == {"reservation": "SINGLE_FRAME"}
    assert "second" in r["stripes-second-frame"].opts
    assert r["large-words-legacy"].opts == {"frame_format": "legacy"}
    for name in ("legacy-skippable-second", "large-stripes-skippable-second",
                 "large-words-skippable-second"):
        assert r[name].opts["skippable"] and "second" in r[name].opts, name
    assert r["legacy-skippable-second"].opts["frame_format"] == "legacy"
    assert len(r["large-fragments-64k"].data) == 65536
    for name in ("tiny-checksums-encoder", "period-dense-encoder"):
        assert r[name].seed % 8 == 0, name


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_one_round_passes(name):
    seed = ROUNDS[name]
    cover = soak.one_round(np.random.default_rng(seed), seed, "cpu")
    assert cover.rounds == 1
    assert set(soak.path_names(CPU)) <= set(cover.paths)
    assert cover.bytes_decoded >= len(_round(seed).expected)
    assert (cover.encoded == 2) == (seed % 8 == 0)


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_corruptions_match_both_host_engines(name):
    """The flipped and the truncated frame: lz4tpu's host engine, the
    port's, and the port's device pipeline give one outcome."""
    rnd = _round(ROUNDS[name])
    res = rnd.reservation
    for frame in (rnd.bad, rnd.truncated):
        want = _jax_outcome(lambda f: lz4tpu.decompress_host(f, res), frame)
        assert soak.outcome(lambda f: lt.decompress_host(f, res),
                            frame) == want
        assert soak.outcome(lambda f: lt.decompress_device(
            f, res, device="cpu"), frame) == want


@pytest.mark.parametrize("name,seed,match", [
    ("content checksum", 16, "fell back to the host"),
    ("no checksum", 12, "bytes differ from offset 100"),
])
def test_guard_sees_a_wrong_kernel_byte(monkeypatch, name, seed, match):
    """One wrong byte from the plain mxu2 route: under a content checksum
    the fallback hands back the host's right bytes, and only the guard
    fails the round; without checksums the bytes differ."""
    rnd = _round(seed)
    assert rnd.kw["content_checksum"] == (name == "content checksum")
    assert not rnd.kw["block_checksum"]
    real = tmx.route_plain

    def wrong(*a, **k):
        rows, ring = real(*a, **k)
        rows[100] ^= 1
        return rows, ring

    monkeypatch.setattr(tmx, "route_plain", wrong)
    if name == "content checksum":      # what the fallback hides
        assert lt.decompress_device(rnd.frame, device="cpu") == rnd.data
    with pytest.raises(soak.SoakFailure, match=match) as e:
        soak.one_round(np.random.default_rng(seed), seed, "cpu")
    assert str(e.value).endswith(
        f"repeat: python -m lz4tpu_torch.exp.soak --seed {seed} --rounds 1 "
        "--device cpu")


def test_host_fallbacks_count_the_host_engine_inside_device_paths():
    """pipeline.HOST_FALLBACKS counts the host engine's calls from a
    device entry point, not the caller's own."""
    data = bytearray(lt.compress(b"abc" * 1000, content_checksum=True))
    n = tpl.HOST_FALLBACKS
    assert lt.decompress_host(bytes(data)) == b"abc" * 1000
    assert lt.decompress_device(bytes(data), device="cpu") == b"abc" * 1000
    assert tpl.HOST_FALLBACKS == n
    data[-1] ^= 1                   # the content checksum
    with pytest.raises(lt.ChecksumError):
        lt.decompress_device(bytes(data), device="cpu")
    assert tpl.HOST_FALLBACKS == n + 1


def test_every_fallback_site_goes_through_host_fallback():
    """The host engine is named only where it is the engine (api, the
    package's exports, the CLI, the soak's oracle) and in
    pipeline._host_fallback, so that HOST_FALLBACKS sees every device
    path that hands a frame to it."""
    allowed = {"api.py", "__init__.py", "cli.py", "exp/soak.py"}
    seen = set()

    def visit(node, where):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            where = node.name
        names = ([a.name for a in node.names]
                 if isinstance(node, (ast.Import, ast.ImportFrom)) else
                 [node.attr] if isinstance(node, ast.Attribute) else
                 [node.id] if isinstance(node, ast.Name) else [])
        if "decompress_host" in names:
            seen.add((rel, where))
        for child in ast.iter_child_nodes(node):
            visit(child, where)

    for path in sorted((REPO / "lz4tpu_torch").rglob("*.py")):
        rel = str(path.relative_to(REPO / "lz4tpu_torch"))
        visit(ast.parse(path.read_text()), "<module>")
    outside = {(rel, fn) for rel, fn in seen if rel not in allowed}
    assert outside == {("pipeline.py", "_host_fallback")}


def test_coverage_names_what_is_missing():
    cover = soak.Coverage()
    gaps = cover.missing(torch.device("cuda"))
    assert "engine fused planned no chain" in gaps
    assert "kernel block_fill never launched" in gaps
    assert "kernel mxu2_route_ab never launched" not in gaps
    assert "path dist.decompress_sharded(4 entries) never ran" in gaps
    with pytest.raises(soak.SoakFailure, match="fell short"):
        cover.require("cpu")
    cover.chains.update({e: 1 for e in soak.ENGINES})
    cover.paths.update({p: 1 for p in soak.path_names(CPU)})
    cover.require("cpu")
    assert [ln.split()[0] for ln in cover.lines()] == ["[soak]"] * 6


def test_cli_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "lz4tpu_torch.exp.soak", "--device", "cpu",
         "--rounds", "3", "--seed", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "base seed 0 on cpu" in r.stdout
    assert "[soak] 3 rounds" in r.stdout and "soak OK: 3 rounds" in r.stdout


def test_cli_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the soak would run")
    r = subprocess.run(
        [sys.executable, "-m", "lz4tpu_torch.exp.soak", "--rounds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert "soak OK" not in r.stdout


# ---------------------------------------------------------------------------
# faults the soak found, each pinned by its seed's frame
# ---------------------------------------------------------------------------

def _every_path_equals_the_host(frame, reservation):
    """Every device path's outcome is the host engine's, and none calls
    decompress_host where the host decodes the frame."""
    want = soak.outcome(lambda f: lt.decompress_host(f, reservation), frame)
    mesh = dist.make_mesh(4, "cpu")
    with DecodeSession(device="cpu") as session:
        for name, res, fn in soak.device_paths(CPU, reservation, session,
                                               mesh, None):
            calls = tpl.HOST_FALLBACKS
            assert soak.outcome(fn, frame) == want, name
            if want[0] == "ok":
                assert tpl.HOST_FALLBACKS == calls, name
    return want


@pytest.mark.parametrize("seed,which", [(1001, "truncated"), (1104, "bad")])
def test_fault_legacy_block_past_the_end(seed, which):
    """A legacy block whose size word runs past the end of input (the
    frame truncated, or a size byte flipped): the streaming engine ends
    the frame there without an error and drops the block; the batch
    parse raised DataCorruption, so every device path served the frame
    through the host fallback.  The JAX package's batch parse still
    raises."""
    rnd = soak.draw_round(np.random.default_rng(seed), seed, 65536)
    frame = getattr(rnd, which)
    assert rnd.opts.get("frame_format") == "legacy"
    want = _every_path_equals_the_host(frame, rnd.reservation)
    assert want == ("ok", b"")
    assert lt.frame.parse_frames(frame, rnd.reservation).blocks == []
    assert _jax_outcome(lambda f: lz4tpu.decompress_host(
        f, rnd.reservation), frame) == want
    with pytest.raises(lz4tpu.errors.DataCorruption,
                       match="Input ended in the middle of a frame"):
        jframe.parse_frames(np.frombuffer(frame, np.uint8), rnd.reservation)


def test_fault_header_cut_after_a_legacy_frame():
    """A legacy frame, then a skippable frame cut inside its size word
    (seed 2926143301's truncated frame): the streaming engine's end of
    frame stays the legacy frame's MAYBE until the next header's size
    word (or a modern header's FLG and BD) is read, so the input decodes
    without an error; the batch parse raised DataCorruption, so every
    device path served it through the host fallback.  The JAX package's
    batch parse still raises."""
    seed = 2926143301
    rnd = soak.draw_round(np.random.default_rng(seed), seed, 65536)
    frame = rnd.truncated
    assert rnd.opts.get("frame_format") == "legacy" and rnd.opts["skippable"]
    assert len(frame) == len(rnd.first) + 6
    want = _every_path_equals_the_host(frame, rnd.reservation)
    assert want == ("ok", rnd.data)
    assert [f.kind for f in lt.frame.parse_frames(frame, lt.FOR_ALL).frames] \
        == ["legacy"]
    assert _jax_outcome(lambda f: lz4tpu.decompress_host(
        f, rnd.reservation), frame) == want
    with pytest.raises(lz4tpu.errors.DataCorruption,
                       match="Input ended in the middle of a frame"):
        jframe.parse_frames(np.frombuffer(frame, np.uint8), rnd.reservation)


@pytest.mark.parametrize("tail,ok", [
    (b"\x04\x22\x4d\x18", True), (b"\x04\x22\x4d\x18\x64", True),
    (b"\x04\x22\x4d\x18\x64\x40", False),
    (b"\x50\x2a\x4d\x18\x01\x00\x00", True),
    (b"\x50\x2a\x4d\x18\x01\x00\x00\x00", False),
    (b"\x50\x2a\x4d\x18\x00\x00\x00\x00", True)])
def test_header_cut_after_a_legacy_frame_as_the_host(tail, ok):
    """After a legacy frame, input that ends inside the next header decodes
    as the streaming engine decodes it: cleanly before a modern header's
    FLG and BD or a skippable size word, else as a frame cut short."""
    data = bytes(range(64))
    frame = lt.compress(data, frame_format="legacy") + tail
    want = _every_path_equals_the_host(frame, lt.FOR_ALL)
    assert (want == ("ok", data)) is ok
    if not ok:
        assert want == ("err", "DataCorruption",
                        "Input ended in the middle of a frame.")


def test_fault_session_fault_precedence():
    """A flipped byte whose batch diagnostic differs from the streaming
    engine's (the buffer size in DataCorruption): the session raised the
    batch parse's error, where decompress_to_device re-derives it
    through the host engine; now both collectors raise the host's.  The
    JAX package's session still raises the batch's."""
    rnd = soak.draw_round(np.random.default_rng(1273), 1273, 65536)
    want = _every_path_equals_the_host(rnd.bad, rnd.reservation)
    assert want[:2] == ("err", "DataCorruption") and "8388616" in want[2]
    with JaxSession(interpret=True) as j:
        got = _jax_outcome(lambda f: j.submit(f).result(), rnd.bad)
    assert got[:2] == want[:2] and got[2] != want[2]
    assert "8388612" in got[2]


def test_fault_sharded_resolver_long_match():
    """A match that begins more than 64 KiB before a span: tier 3 (the
    span-sharded resolver) pointed its bytes back to the match's first
    period, past the tails the spans exchange, and returned wrong bytes
    from the second span on (offset 99,712 of 398,447 on four entries),
    without an error.  The JAX package's resolver does the same."""
    seed = 1190175549
    rnd = soak.draw_round(np.random.default_rng(seed), seed, None)
    assert rnd.kind == "period" and len(rnd.expected) == 398447
    buf = np.frombuffer(rnd.frame, np.uint8)
    table = tpl.build_seq_table(
        buf, tpl.parse_frames(buf, rnd.reservation), rnd.reservation,
        rnd.frame)
    assert not dist._use_chains(table, 4)           # tier 3
    calls = tpl.HOST_FALLBACKS
    got = dist.decompress_sharded(rnd.frame, dist.make_mesh(4, "cpu"),
                                  rnd.reservation)
    assert got == rnd.expected and tpl.HOST_FALLBACKS == calls
    from lz4tpu import dist as jdist

    got = jdist.decompress_sharded(rnd.frame, jdist.make_mesh(4),
                                   rnd.reservation)
    assert soak._first_diff(got, rnd.expected) == 99712


def test_session_refuses_a_wrong_kernel_byte(monkeypatch):
    """A checksum fault found when a ticket is collected goes through
    the host engine for its diagnostic; where the host decodes the
    frame, the collector raises the disagreement and never serves the
    host's bytes.  With one wrong byte from the plain mxu2 route under a
    content checksum, every collector raises, one host call each."""
    rnd = _round(16)
    assert rnd.kw["content_checksum"]
    real = tmx.route_plain

    def wrong(*a, **k):
        rows, ring = real(*a, **k)
        rows[100] ^= 1
        return rows, ring

    monkeypatch.setattr(tmx, "route_plain", wrong)
    says = ("the host engine decodes a frame that the device path "
            "rejected with ChecksumError")
    calls = tpl.HOST_FALLBACKS
    with DecodeSession(device="cpu") as s:
        with pytest.raises(RuntimeError, match=says):
            s.submit(rnd.frame).result()
        assert tpl.HOST_FALLBACKS == calls + 1
        with pytest.raises(RuntimeError, match=says):
            s.submit(rnd.frame).result_on_device()
        assert tpl.HOST_FALLBACKS == calls + 2
        t = s.submit(rnd.frame)
        t.result_on_device(verify="none")
        with pytest.raises(RuntimeError, match=says):
            t.result()
        assert tpl.HOST_FALLBACKS == calls + 3


def test_session_refuses_a_batch_rejection_of_a_sound_frame(monkeypatch):
    """Where the batch stages reject a frame the host engine decodes,
    the ticket raises that disagreement, not the host's bytes; a frame
    the host rejects raises the host's error (the fault-precedence
    case)."""
    rnd = _round(1)
    bad = bytes(rnd.first[:-1])
    want = soak.outcome(lambda f: lt.decompress_host(f, rnd.reservation),
                        bad)
    assert want[0] == "err"

    def reject(*a, **k):
        raise lt.DataCorruption("batch stage fault")

    monkeypatch.setattr(tpl, "build_seq_table", reject)
    with DecodeSession(rnd.reservation, device="cpu") as s:
        with pytest.raises(RuntimeError, match="rejected with "
                           "DataCorruption: batch stage fault"):
            s.submit(rnd.frame).result()
        assert soak.outcome(lambda f: s.submit(f).result(), bad) == want
