"""``python -m lz4tpu_torch.cli`` held against ``lz4tpu.cli``.

Both ``main`` functions run in process on the same argv and stdin, as
tests/test_cli.py runs ``lz4tpu.cli``: stdout and the exit code must be
equal byte for byte; stderr too, once the program name of argparse's
usage lines and the times and rates of ``lz4-bench`` are masked.  The
port's bench runs its device, sharded and pipeline backends on the CPU
(``LZ4TPU_DEVICE=cpu``); the JAX package's runs on its CPU devices.
"""

import io
import json
import re
import struct
import subprocess
import sys

import numpy as np
import pytest

import lz4tpu
from lz4tpu import cli as jcli

from lz4tpu_torch import cli as tcli


@pytest.fixture(autouse=True)
def _port_on_the_cpu(monkeypatch):
    monkeypatch.setenv(tcli.DEVICE_ENV, "cpu")


def _run(mod, argv, stdin: bytes = b""):
    """(rc, stdout bytes, stderr text) of ``mod.main(argv)``.  Text
    prints and binary writes share one BytesIO, as on a real fd."""
    in_b, out_b, err_t = io.BytesIO(stdin), io.BytesIO(), io.StringIO()
    fake_in = io.TextIOWrapper(in_b, encoding="utf-8")
    fake_out = io.TextIOWrapper(out_b, encoding="utf-8", write_through=True)
    old = sys.stdin, sys.stdout, sys.stderr
    sys.stdin, sys.stdout, sys.stderr = fake_in, fake_out, err_t
    try:
        rc = mod.main(list(argv))
    except SystemExit as e:            # argparse
        rc = e.code
    finally:
        fake_out.flush()
        sys.stdin, sys.stdout, sys.stderr = old
    return rc, out_b.getvalue(), err_t.getvalue()


_TIMES = [(re.compile(r"\d+\.\d+ ?ms"), "T ms"),
          (re.compile(r"\d+\.\d+ MB/s"), "R MB/s"),
          (re.compile(r"\blz4tpu_torch\b"), "lz4tpu")]


def _masked(err: str) -> str:
    for pat, rep in _TIMES:
        err = pat.sub(rep, err)
    return err


def _same(argv, stdin: bytes = b""):
    """Both CLIs on ``argv``: equal rc and stdout, and equal masked
    stderr; returns the port's result."""
    want = _run(jcli, argv, stdin)
    got = _run(tcli, argv, stdin)
    assert got[0] == want[0], (got[2], want[2])
    assert got[1] == want[1]
    assert _masked(got[2]) == _masked(want[2])
    return got


def _usage(text: str) -> str:
    """argparse's text with the program name masked and the indentation
    that follows its length collapsed."""
    return re.sub(r"\s+", " ", _masked(text))


def _text(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(512)]
    return b"".join(frags[i] for i in rng.integers(0, 512, n // 4))[:n]


PAYLOAD = _text(90_000)
SKIP = struct.pack("<II", 0x184D2A50, 5) + b"hello"


def _frames() -> dict:
    c = lz4tpu.compress
    bsum = bytearray(c(PAYLOAD, block_checksum=True, block_max_code=4))
    bsum[300] ^= 0x20
    csum = bytearray(c(PAYLOAD))
    csum[-1] ^= 0x01
    return {
        "modern": c(PAYLOAD),
        "options": c(PAYLOAD, block_checksum=True, content_size=True,
                     block_max_code=4, block_independence=True),
        "legacy": c(PAYLOAD, frame_format="legacy"),
        "legacy+modern": (c(PAYLOAD[:5000], frame_format="legacy")
                          + c(PAYLOAD[5000:20000])),
        "skippable": SKIP + c(PAYLOAD[:3000]) + SKIP,
        "empty frame": c(b""),
        "no input": b"",
        "block checksum": bytes(bsum),
        "content checksum": bytes(csum),
        "truncated": c(PAYLOAD)[:-300],
        "short": c(PAYLOAD)[:5],
        "bad magic": b"\x00\x11\x22\x33" + c(PAYLOAD)[4:],
    }


FRAMES = _frames()


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("tool", ["unlz4", "unlz4-simple"])
def test_decoders(tool, name):
    rc, out, err = _same([tool], FRAMES[name])
    if name in ("modern", "options", "legacy"):
        assert rc == 0 and out == PAYLOAD
    if name in ("block checksum", "content checksum", "bad magic"):
        assert rc == 1 and err


@pytest.mark.parametrize("name", ["modern", "options", "legacy",
                                  "skippable", "short", "bad magic",
                                  "no input"])
def test_lz4hdrinfo(name):
    rc, out, _err = _same(["lz4hdrinfo"], FRAMES[name])
    assert b"Header Info" in out


@pytest.mark.parametrize("data", [b"", b"abc", PAYLOAD])
def test_xxhash32(data):
    rc, out, _err = _same(["xxhash32"], data)
    assert rc == 0 and out == b"0x%08x\n" % lz4tpu.xxh32(data)


@pytest.mark.parametrize("flags", [
    [], ["--no-content-checksum"], ["--block-checksum"], ["--content-size"],
    ["--block-independence"], ["--max-chain", "8"], ["--level", "2"],
    ["--level", "10"], ["--legacy"], ["--block-max-code", "4"],
    ["--block-max-code", "5", "--block-checksum", "--content-size"],
])
def test_lz4_compress(flags):
    data = PAYLOAD[:40_000] if "10" in flags else PAYLOAD
    rc, out, _err = _same(["lz4-compress", *flags], data)
    assert rc == 0 and lz4tpu.decompress(out) == data


@pytest.mark.parametrize("argv", [[], ["nope"], ["lz4-compress",
                                                 "--block-max-code", "9"],
                                  ["lz4-bench"], ["--help"]])
def test_argument_errors(argv):
    """argparse's exits: the same codes, and the same usage and help
    text but for the program's name."""
    want = _run(jcli, argv)
    got = _run(tcli, argv)
    assert got[0] == want[0] and got[0] in (0, 2)
    assert _usage(got[2]) == _usage(want[2])
    assert _usage(got[1].decode()) == _usage(want[1].decode())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    payload = d / "payload.bin"
    payload.write_bytes(PAYLOAD[:60_000] + bytes(20_000))
    frame = d / "frame.lz4"
    frame.write_bytes(lz4tpu.compress(payload.read_bytes(),
                                      block_max_code=4))
    return {"payload": str(payload), "frame": str(frame),
            "missing": str(d / "missing.lz4")}


@pytest.mark.parametrize("backend", ["host", "device", "auto", "sharded",
                                     "pipeline", "device-emit"])
def test_bench_decode(backend, files):
    rc, out, err = _same(["lz4-bench", "--reps", "1", "--backend", backend,
                          files["frame"]])
    assert rc == 0 and out == b"" and "TOTAL:" in err


@pytest.mark.parametrize("backend", ["host", "device", "device-emit",
                                     "auto", "sharded"])
def test_bench_encode(backend, files):
    rc, out, err = _same(["lz4-bench", "--encode", "--reps", "1",
                          "--backend", backend, files["payload"]])
    assert rc == 0 and "MB/s compressed" in err


def test_bench_stats(files):
    """The JAX package's lines, and the port's own count of the blocks
    its one native scan wrote into the table (two 64 KiB blocks)."""
    argv = ["lz4-bench", "--reps", "1", "--backend", "device", "--stats",
            files["frame"]]
    want = _run(jcli, argv)
    rc, out, err = _run(tcli, argv)
    assert (rc, out) == want[:2]
    assert "\n  arena_blocks=2\n" in err
    assert _masked(err.replace("  arena_blocks=2\n", "")) == \
        _masked(want[2])
    assert rc == 0 and "engines=" in err


def test_bench_missing_file(files):
    rc, _out, err = _same(["lz4-bench", files["missing"]])
    assert rc == 1 and err.startswith("lz4-bench: ")


def test_bench_profile(files, tmp_path):
    """--profile writes a torch.profiler trace into DIR (the JAX
    package's run writes its own beside it) and says so on stderr, on
    success and when the bench fails."""
    for argv, rc_want in (([files["frame"]], 0), ([files["missing"]], 1)):
        d = tmp_path / f"trace{rc_want}"
        rc, out, err = _same(["lz4-bench", "--reps", "1", "--profile",
                              str(d), *argv])
        assert rc == rc_want and out == b""
        assert err.rstrip().endswith(f"profiler trace written to {d}")
        assert (d / "trace.json").stat().st_size > 0


def test_bench_profile_carries_spans(files, tmp_path):
    """The port's --profile trace holds its own spans beside the
    operations (a device decode's token scan among them)."""
    d = tmp_path / "trace"
    rc, _out, _err = _run(tcli, ["lz4-bench", "--reps", "1", "--backend",
                                 "device", "--profile", str(d),
                                 files["frame"]])
    assert rc == 0
    names = {e.get("name") for e in
             json.loads((d / "trace.json").read_text())["traceEvents"]}
    assert {"lz4tpu_torch.decode", "lz4tpu_torch.decode.scan",
            "lz4tpu_torch.decode.scan.blocks"} <= names


@pytest.mark.parametrize("entry,argv,stdin", [
    ("main_unlz4", [], "modern"), ("main_unlz4_simple", [], "legacy"),
    ("main_lz4hdrinfo", [], "options"), ("main_xxhash32", [], "modern"),
    ("main_compress", ["--block-max-code", "4"], "no input"),
    ("main_bench", ["--reps", "1"], None)])
def test_tool_entry_points(entry, argv, stdin, files):
    """Each main_* runs its tool on the argv it is given, as lz4tpu's."""
    import types

    if stdin is None:
        argv, data = [*argv, files["frame"]], b""
    else:
        data = FRAMES[stdin] if stdin != "no input" else PAYLOAD
    want = _run(types.SimpleNamespace(main=getattr(jcli, entry)), argv, data)
    got = _run(types.SimpleNamespace(main=getattr(tcli, entry)), argv, data)
    assert got[:2] == want[:2] and got[0] == 0
    assert _masked(got[2]) == _masked(want[2])


def test_runs_as_a_module():
    """``python -m lz4tpu_torch.cli`` is the port's surface."""
    data = lz4tpu.compress(PAYLOAD)
    r = subprocess.run([sys.executable, "-m", "lz4tpu_torch.cli", "unlz4"],
                       input=data, capture_output=True, timeout=120)
    assert r.returncode == 0 and r.stdout == PAYLOAD
