"""Branches of the port's host layer that no other test takes, found by
``tools/pycov_torch.py`` (COVERAGE_TORCH.md), each held against the JAX
package's outcome on the same bytes: the output, or the exception's
class and message.  Tolerance 0.

- ``content_size`` frames under each concrete reservation (``SZ_64_KIB``
  ... ``SZ_8_MIB``), and frames whose declared size is wrong, through
  ``decompress_host``, the streaming ``Decompressor`` and
  ``decompress_to_device(device="cpu")``;
- tier 3 of ``dist.decompress_sharded`` (the span-sharded resolver)
  across two processes over gloo, on the long-match payload that broke
  it in one process; its bytes are held to the host engine, since
  ``lz4tpu.dist`` returns wrong bytes on it (a known fault of the
  reference package);
- the coverage tool itself: it records, merges and reports hit sets.
"""

import json
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch as lt
from lz4tpu.xxh32 import xxh32

REPO = pathlib.Path(__file__).resolve().parent.parent
CONCRETE = ("SZ_64_KIB", "SZ_256_KIB", "SZ_1_MIB", "SZ_4_MIB", "SZ_8_MIB")


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 12)),
                          dtype=np.uint8).tobytes() for _ in range(1024)]
    return b"".join(frags[i] for i in rng.integers(0, 1024, n // 6 + 16))[:n]


PAYLOAD = _text(150_000, 31) + bytes(90_000) + _text(60_000, 32)


def _with_content_size(frame: bytes, size: int) -> bytes:
    """``frame`` (a one-frame modern stream written with
    ``content_size=True``) with its declared size replaced and its
    header checksum made right again."""
    assert frame[4] & 0x08
    desc = frame[4:6] + struct.pack("<Q", size)
    return (frame[:4] + desc + bytes([(xxh32(desc) >> 8) & 0xFF])
            + frame[15:])


def _content_size_frames() -> dict:
    c = lz4tpu.compress
    small = PAYLOAD[:100_000]
    exact = c(small, content_size=True, block_max_code=4)
    one = c(small, content_size=True, block_max_code=7)
    return {
        "blocks64k": exact,
        "blocks256k": c(PAYLOAD, content_size=True, block_max_code=5,
                        block_checksum=True),
        "blocks1m": c(PAYLOAD, content_size=True, block_max_code=6,
                      block_independence=True),
        "blocks4m": c(PAYLOAD, content_size=True, block_max_code=7,
                      content_checksum=False),
        "declared_short": _with_content_size(exact, len(small) - 1),
        "declared_long": _with_content_size(exact, len(small) + 5),
        "declared_zero": _with_content_size(exact, 0),
        "empty": c(b"", content_size=True),
        "legacy": c(small, frame_format="legacy"),
        "two_frames": exact + c(PAYLOAD[:20_000], content_size=True,
                                block_max_code=7),
        # one block: the single-block fast path of the sequence table
        "single_declared_short": _with_content_size(one, len(small) - 7),
        "single_declared_long": _with_content_size(one, len(small) + 1),
    }


FRAMES = _content_size_frames()


def _outcome(mod, fn, arg) -> tuple:
    """``("ok", fn(arg))``, or the exception's class name and message
    (``ValueError`` too)."""
    try:
        return ("ok", fn(arg))
    except (mod.Lz4Error, ValueError) as e:
        return ("err", type(e).__name__, str(e))


def _stream(mod, res, data, chunk=4093) -> bytes:
    ctx = mod.Decompressor(res)
    arr = np.frombuffer(data, np.uint8)
    out, pos = bytearray(), 0
    while pos < arr.size:
        used, piece = ctx.update(arr[pos:pos + chunk])
        out += piece
        pos += used
        if used == 0 and not piece:
            break
    return bytes(out) + ctx.end_of_frame.name.encode()


@pytest.mark.parametrize("res", CONCRETE)
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_content_size_frames_under_concrete_reservations(name, res):
    data = FRAMES[name]
    jr, tr = lz4tpu.Reservation[res], lt.Reservation[res]
    pairs = {
        "decompress_host": (
            _outcome(lz4tpu, lambda d: lz4tpu.decompress_host(d, jr), data),
            _outcome(lt, lambda d: lt.decompress_host(d, tr), data)),
        "Decompressor": (
            _outcome(lz4tpu, lambda d: _stream(lz4tpu, jr, d), data),
            _outcome(lt, lambda d: _stream(lt, tr, d), data)),
        "decompress_to_device": (
            _outcome(lz4tpu, lambda d: np.asarray(
                jpl.decompress_to_device(d, jr)).tobytes(), data),
            _outcome(lt, lambda d: lt.decompress_to_device(
                d, tr, device="cpu").numpy().tobytes(), data)),
    }
    for path, (want, got) in pairs.items():
        assert got == want, path
    # what each case is for: a fault where a case names one
    host = pairs["decompress_host"][1]
    if name.startswith("declared"):
        assert host[:2] == ("err", "DataCorruption"), host
    if name == "blocks4m" and res in CONCRETE[:3]:
        assert host[:2] == ("err", "TooLittleMemory"), host
    if name == "blocks64k":
        assert host == ("ok", PAYLOAD[:100_000])

    if name.startswith("single_declared") and res in CONCRETE[3:]:
        assert host[:2] == ("err", "DataCorruption"), host


# ---------------------------------------------------------------------------
# error branches of the host layer, each against lz4tpu's outcome
# ---------------------------------------------------------------------------

def _both(fn) -> list:
    """The outcome of ``fn(mod)`` for the port and then for lz4tpu."""
    return [_outcome(mod, fn, mod) for mod in (lt, lz4tpu)]


def _modern(flg: int, bd: int, body: bytes) -> bytes:
    desc = bytes([flg, bd])
    return (struct.pack("<I", 0x184D2204) + desc
            + bytes([(xxh32(desc) >> 8) & 0xFF]) + body)


def _legacy(*blocks: bytes, size_word: int | None = None) -> bytes:
    out = struct.pack("<I", 0x184C2102)
    for b in blocks:
        out += struct.pack("<I", len(b) if size_word is None
                           else size_word) + b
    return out


LINKED = lz4tpu.compress(PAYLOAD[:200_000], block_max_code=4)
SKIP = struct.pack("<II", 0x184D2A50, 3) + b"abc"

# parse_frames(data, reservation) on the frame parse's error branches
PARSE_CASES = {
    "too_few_header_bytes": (LINKED[:5], "USE_FIRST"),
    "too_few_bytes_concrete": (LINKED[:5], "SZ_8_MIB"),
    "single_frame_trailing": (LINKED + LINKED, "SINGLE_FRAME"),
    "skippable_then_big_frame": (SKIP + lz4tpu.compress(
        PAYLOAD[:70_000], block_max_code=7), "USE_FIRST"),
    "legacy_then_next_frame": (lz4tpu.compress(
        PAYLOAD[:1000], frame_format="legacy") + LINKED, "SINGLE_FRAME"),
    "legacy_block_too_large": (_legacy(b"x" * 16, size_word=9 << 20),
                               "SZ_8_MIB"),
}


@pytest.mark.parametrize("name", sorted(PARSE_CASES))
def test_frame_parse_error_branches(name):
    data, res = PARSE_CASES[name]

    def run(mod):
        parsed = mod.frame.parse_frames(np.frombuffer(data, np.uint8),
                                        mod.Reservation[res])
        return [(f.kind, len(f.blocks)) for f in parsed.frames]

    got, want = _both(run)
    assert got == want
    assert got[0] == "err" or name == "skippable_then_big_frame", got
    # the public decoder agrees too
    got, want = _both(lambda m: m.decompress_host(data, m.Reservation[res]))
    assert got == want


def _ring(mod, src: bytes, size: int, out_pos: int, hist: int,
          prefix: bytes = b""):
    buf = np.zeros(size, np.uint8)
    buf[:len(prefix)] = np.frombuffer(prefix[:size], np.uint8)
    op = mod.block.decode_block_ring_py(np.frombuffer(src, np.uint8), buf,
                                        out_pos, hist)
    return op, buf.tobytes()


# (raw block, buffer size, out_pos, out_pos_history) for the exact
# block decoder's branches
BLOCK_CASES = {
    "length_bytes_missing": (b"\xf0", 64, 0, 0),
    "literals_missing_with_match": (b"\x51ab", 64, 0, 0),
    "literals_missing": (b"\x50ab", 64, 0, 0),
    "literals_past_buffer": (b"\x50abcde", 4, 0, 0),
    "match_after_last_literals": (b"\x11a", 64, 0, 0),
    "offset_bytes_missing": (b"\x10a\x01", 64, 0, 0),
    "offset_zero": (b"\x10a\x00\x00\x00", 64, 0, 0),
    "match_past_buffer": (b"\x1fa\x01\x00\x20", 16, 0, 0),
    "match_from_history": (b"\x10a\x0a\x00\x00", 64, 2, 40),
    "history_out_of_range": (b"\x10a\x0a\x00\x00", 64, 2, 3),
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_decoder_error_branches(name):
    src, size, out_pos, hist = BLOCK_CASES[name]
    prefix = bytes(range(48))
    got, want = _both(lambda m: _ring(m, src, size, out_pos, hist, prefix))
    assert got == want
    if name == "match_from_history":
        assert got[0] == "ok"
    else:
        assert got[0] == "err", got


def _update_into(mod, data, buffer, chunk=1000):
    ctx = mod.Decompressor(mod.Reservation.SZ_64_KIB)
    arr = np.frombuffer(data, np.uint8)
    out, pos = bytearray(), 0
    while pos < arr.size:
        used, first, last = ctx.update_into(arr[pos:pos + chunk], buffer)
        view = np.frombuffer(memoryview(buffer), np.uint8)
        out += view[first:last + 1].tobytes()
        pos += used
    return bytes(out)


def test_streaming_decompressor_error_branches():
    ok = lz4tpu.compress(PAYLOAD[:50_000], block_max_code=4)
    bad = bytearray(ok)
    bad[200] ^= 0xFF
    need = lt.Decompressor(lt.Reservation.SZ_64_KIB).min_buffer_size
    cases = {
        "plain_needs_concrete": lambda m: m.Decompressor(
            m.Reservation.USE_FIRST),
        "from_header_short": lambda m: m.Decompressor.from_header(
            LINKED[:6], m.Reservation.USE_FIRST)[1],
        "from_header_single": lambda m: m.Decompressor.from_header(
            LINKED, m.Reservation.SINGLE_FRAME)[1],
        "update_empty": lambda m: m.Decompressor(
            m.Reservation.SZ_64_KIB).update(b""),
        "into_bytearray": lambda m: _update_into(m, ok, bytearray(need)),
        "into_array": lambda m: _update_into(m, ok, np.zeros(need, np.uint8)),
        "into_2d": lambda m: _update_into(m, ok, np.zeros((2, need),
                                                          np.uint8)),
        "into_int16": lambda m: _update_into(m, ok, np.zeros(need,
                                                             np.int16)),
        "into_readonly": lambda m: _update_into(m, ok, bytes(need)),
        "into_small": lambda m: _update_into(m, ok, bytearray(need - 1)),
        "into_corrupt": lambda m: _update_into(m, bytes(bad),
                                               bytearray(need)),
        "single_frame_trailing": lambda m: _stream(
            m, m.Reservation.SINGLE_FRAME, LINKED + LINKED),
        "legacy_then_next_frame_single": lambda m: _stream(
            m, m.Reservation.SINGLE_FRAME, PARSE_CASES[
                "legacy_then_next_frame"][0]),
    }
    for name, fn in cases.items():
        got, want = _both(fn)
        assert got == want, name
    assert _both(cases["into_bytearray"])[0] == ("ok", PAYLOAD[:50_000])
    assert _both(cases["into_small"])[0][1] == "TooLittleMemory"


def _raw_block(mod, src: bytes, size: int, chunk: int):
    ctx = mod.Decompressor.for_block(len(src), mod.Reservation.SZ_64_KIB)
    eof = [ctx.is_end_of_frame().name]
    out, pos = bytearray(), 0
    while pos < len(src):
        used, piece = ctx.update(src[pos:pos + chunk])
        out += piece
        pos += used
    eof.append(ctx.end_of_frame.name)
    return bytes(out), eof


@pytest.mark.parametrize("chunk", [1, 100, 1 << 20])
def test_raw_block_decompressor(chunk):
    """``Decompressor.for_block``: one raw LZ4 block, its end of frame
    NO until the block is read, then YES."""
    frame = lz4tpu.compress(PAYLOAD[:40_000], block_max_code=4,
                            content_checksum=False)
    size = struct.unpack_from("<I", frame, 7)[0]
    assert not size & 0x80000000
    src = frame[11:11 + size]
    got, want = _both(lambda m: _raw_block(m, src, 65536, chunk))
    assert got == want
    assert got[1] == (PAYLOAD[:40_000], ["NO", "YES"])


def test_one_shot_api_error_branches():
    ok = LINKED
    n = len(PAYLOAD[:200_000])
    cases = {
        "min_buffer_use_first": lambda m: m.min_buffer_size(
            m.Reservation.USE_FIRST),
        "min_buffer_single": lambda m: m.min_buffer_size(
            m.Reservation.SINGLE_FRAME),
        "into_2d": lambda m: m.decompress_into(ok, np.zeros((2, n),
                                                            np.uint8)),
        "into_readonly": lambda m: m.decompress_into(ok, bytes(n)),
        "into_bytearray": lambda m: m.decompress_into(ok, bytearray(n)),
        "into_empty_input": lambda m: m.decompress_into(b"", bytearray(8)),
        "into_use_first": lambda m: m.decompress_into(
            ok, bytearray(n), m.Reservation.USE_FIRST),
        "into_too_small": lambda m: m.decompress_into(ok, bytearray(n - 1)),
        "into_truncated": lambda m: m.decompress_into(ok[:-3],
                                                      bytearray(n)),
        "host_empty": lambda m: m.decompress_host(b""),
        "host_use_first_truncated": lambda m: m.decompress_host(
            ok[:-3], m.Reservation.USE_FIRST),
    }
    for name, fn in cases.items():
        got, want = _both(fn)
        assert got == want, name


def _compressor(mod, steps):
    c = mod.Compressor(block_max_code=4)
    out = b""
    for step in steps:
        out += c.update(b"xyz" * 9000) if step == "update" else c.finish()
    return out


@pytest.mark.parametrize("steps", [("finish",), ("update", "finish"),
                                   ("finish", "finish"),
                                   ("finish", "update")])
def test_streaming_compressor_branches(steps):
    got, want = _both(lambda m: _compressor(m, steps))
    assert got == want


def _device_cases() -> dict:
    """Inputs for the batched pipeline's rarer branches."""
    empty_block = _modern(0x60, 0x40, struct.pack("<I", 1) + b"\x00"
                          + bytes(4))
    # linked blocks under a set independence flag
    desc = bytes([LINKED[4] | 0x20, LINKED[5]])
    lie = bytes(LINKED[:4] + desc + bytes([(xxh32(desc) >> 8) & 0xFF])
                + LINKED[7:])
    # one block whose first match reaches 15 bytes before the frame
    block = b"\x14a\x10\x00" + b"\x50hello"
    reach = _modern(0x60, 0x40, struct.pack("<I", len(block)) + block
                    + bytes(4))
    # one block that decodes past the 64 KiB its header declares, into
    # the ring's history room; under USE_FIRST the batch host decode
    # sizes its output by the header and grows it
    big = lz4tpu.compress(PAYLOAD[:100_000], block_max_code=7)
    desc = bytes([big[4], 0x40])
    oversized = (big[:4] + desc + bytes([(xxh32(desc) >> 8) & 0xFF])
                 + big[7:])
    return {
        "oversized_block": (oversized, "SZ_8_MIB"),
        "oversized_block_use_first": (oversized, "USE_FIRST"),
        "empty_block_then_text": (empty_block + LINKED, "SZ_8_MIB"),
        "independence_flag_lies": (lie, "SZ_8_MIB"),
        "backref_before_frame": (reach, "SZ_8_MIB"),
        "backref_before_frame_use_first": (reach, "USE_FIRST"),
        "backref_before_second_frame": (LINKED + reach, "SZ_8_MIB"),
        "truncated_single_frame": (LINKED[:-9], "SINGLE_FRAME"),
    }


DEVICE_CASES = _device_cases()


@pytest.mark.parametrize("name", sorted(DEVICE_CASES))
def test_batched_pipeline_branches(name):
    data, res = DEVICE_CASES[name]
    jr, tr = lz4tpu.Reservation[res], lt.Reservation[res]
    want = _outcome(lz4tpu, lambda d: np.asarray(
        jpl.decompress_to_device(d, jr)).tobytes(), data)
    got = _outcome(lt, lambda d: lt.decompress_to_device(
        d, tr, device="cpu").numpy().tobytes(), data)
    assert got == want
    assert _outcome(lt, lambda d: lt.decompress_device(
        d, tr, device="cpu"), data) == _outcome(
        lz4tpu, lambda d: jpl.decompress_device(d, jr), data)
    assert got == _outcome(lt, lambda d: lt.decompress_host(d, tr), data)


def _tool(*argv, cwd):
    r = subprocess.run([sys.executable, str(REPO / "tools" / "pycov_torch.py"),
                        *map(str, argv)], cwd=cwd, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def test_coverage_tool_records_merges_and_reports(tmp_path):
    """``run`` records the port's lines and branches (none of the JAX
    package's) into a hit set and merges a second run into it;
    ``report`` counts them per file, lists a line that only the card
    set holds apart from the missed ones, and keeps the notes."""
    (tmp_path / "a.py").write_text(
        "import lz4tpu_torch as lt\n"
        "assert lt.decompress(lt.compress(b'abc' * 999)) == b'abc' * 999\n")
    (tmp_path / "b.py").write_text(
        "import lz4tpu_torch as lt\n"
        "try:\n"
        "    lt.decompress_host(b'\\x00\\x01\\x02\\x03' * 4)\n"
        "except lt.NotSupported:\n"
        "    pass\n")
    hits = tmp_path / "cpu.json"
    _tool("run", "--hits", hits, "--script", tmp_path / "a.py", cwd=tmp_path)
    first = json.loads(hits.read_text())
    _tool("run", "--hits", hits, "--script", tmp_path / "b.py", cwd=tmp_path)
    merged = json.loads(hits.read_text())
    assert all(k.startswith("lz4tpu_torch/") for k in merged)
    assert set(first["lz4tpu_torch/api.py"]["lines"]) <= set(
        merged["lz4tpu_torch/api.py"]["lines"])
    assert len(merged["lz4tpu_torch/errors.py"]["lines"]) > len(
        first["lz4tpu_torch/errors.py"]["lines"])
    assert any(merged["lz4tpu_torch/api.py"]["branches"].values())
    # a card set holding one line of the launch helper that no CPU run
    # reaches
    src = (REPO / "lz4tpu_torch" / "_kernels.py").read_text().splitlines()
    line = 1 + next(i for i, t in enumerate(src)
                    if "stream = torch.cuda.current_stream(device)" in t)
    assert line not in merged["lz4tpu_torch/_kernels.py"]["lines"]
    card = tmp_path / "card.json"
    card.write_text(json.dumps({"lz4tpu_torch/_kernels.py": {
        "lines": [line], "branches": {}}}))
    out = tmp_path / "COV.md"
    out.write_text("old table\n\n## Notes\n\n- a note that stays\n")
    _tool("report", "--cpu", hits, "--card", card, "--out", out,
          cwd=tmp_path)
    text = out.read_text()
    assert "old table" not in text and "- a note that stays" in text
    rows = {r.split("|")[1].strip(): r for r in text.splitlines()
            if r.startswith("| lz4tpu_torch/")}
    assert set(rows) == {f"lz4tpu_torch/{p.relative_to(REPO / 'lz4tpu_torch')}"
                         for p in (REPO / "lz4tpu_torch").rglob("*.py")
                         if "__pycache__" not in p.parts}
    cells = [c.strip() for c in rows["lz4tpu_torch/_kernels.py"].split("|")]
    assert cells[4] == "1"                      # card only
    card_part = text.split("## Lines reached only on the card")[1].split(
        "## Lines missed by both")[0]
    assert f"`lz4tpu_torch/_kernels.py`: {line}\n" in card_part
    missed = text.split("## Lines missed by both")[1].split("## Lines of")[0]
    kern = next(ln for ln in missed.splitlines()
                if ln.startswith("- `lz4tpu_torch/_kernels.py`"))
    assert str(line) not in kern.split(": ")[1].replace("-", ", ").split(", ")
