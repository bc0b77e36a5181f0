"""The port's own host layer against the JAX package's, module by
module, on the same bytes: frame parse, sequence table, xxh32, the
encoder, the host decoders and the streaming engine.  The copies share
no class with the originals, so results compare field by field and
exceptions by class name and message.  Tolerance 0.
"""

import dataclasses
import struct

import numpy as np
import pytest

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu import native as jnative
from lz4tpu.frame import parse_frames as jparse
from lz4tpu_torch import native as tnative
from lz4tpu_torch.frame import parse_frames as tparse


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(4096)]
    picks = rng.integers(0, 4096, n // 5 + 16)
    return b"".join(frags[i] for i in picks)[:n]


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


PAYLOAD = (_frag_text(90_000, 1) + bytes(40_000) + _rand(20_000, 2)
           + b"abc" * 9000)

COMPRESS_CASES = {
    "modern": {},
    "legacy": dict(frame_format="legacy"),
    "block_checksums": dict(block_checksum=True, block_max_code=4),
    "independent": dict(block_independence=True, block_max_code=4),
    "content_size": dict(content_size=True, content_checksum=False),
    "level1": dict(level=1),
    "level10": dict(level=10, block_max_code=5),
}


@pytest.mark.parametrize("name", sorted(COMPRESS_CASES))
def test_compress_bytes_equal(name):
    kw = COMPRESS_CASES[name]
    blob = PAYLOAD[:60_000] if name == "level10" else PAYLOAD
    assert lz4tpu_torch.compress(blob, **kw) == lz4tpu.compress(blob, **kw)


def test_streaming_compressor_equals_one_shot():
    kw = dict(block_max_code=4, block_checksum=True)
    c = lz4tpu_torch.Compressor(**kw)
    out = b"".join(c.update(PAYLOAD[i:i + 7777])
                   for i in range(0, len(PAYLOAD), 7777)) + c.finish()
    assert out == lz4tpu.compress(PAYLOAD, **kw)


@pytest.mark.parametrize("backend", ["device", "device-emit"])
def test_device_encoder_bytes_equal(backend):
    assert lz4tpu_torch.compress(b"abc" * 100, backend=backend,
                                 device="cpu") == lz4tpu.compress(
        b"abc" * 100, backend=backend)


def _frames():
    skip = struct.pack("<II", 0x184D2A50, 5) + b"hello"
    return (lz4tpu.compress(PAYLOAD, block_checksum=True, block_max_code=4,
                            content_size=True)
            + skip + lz4tpu.compress(PAYLOAD[:30_000], frame_format="legacy")
            + lz4tpu.compress(b"") + lz4tpu.compress(_rand(70_000, 3)))


def _fields(obj):
    """A dataclass of either package as plain nested data."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.tolist())
    return obj


def test_parse_frames_fields_equal():
    data = _frames()
    buf = np.frombuffer(data, np.uint8)
    got = tparse(buf, lz4tpu_torch.FOR_ALL)
    want = jparse(buf, lz4tpu.FOR_ALL)
    assert _fields(got) == _fields(want)
    assert len(got.frames) >= 4


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("which", ["multi", "single"])
def test_build_seq_table_columns_equal(which, pooled):
    data = _frames() if which == "multi" else lz4tpu.compress(PAYLOAD)
    buf = np.frombuffer(data, np.uint8)
    got = tpl.build_seq_table(buf, tparse(buf, lz4tpu_torch.FOR_ALL),
                              lz4tpu_torch.FOR_ALL, data, pooled_cols=pooled)
    got = {k: v for k, v in _fields(got).items() if k != "pre"}
    want = jpl.build_seq_table(buf, jparse(buf, lz4tpu.FOR_ALL),
                               lz4tpu.FOR_ALL, data, pooled_cols=pooled)
    want = {k: v for k, v in _fields(want).items() if k != "pre"}
    assert got == want
    chains_t = [dataclasses.astuple(c) for c in tpl._chains_of(
        tpl.build_seq_table(buf, tparse(buf, lz4tpu_torch.FOR_ALL),
                            lz4tpu_torch.FOR_ALL, data))]
    chains_j = [dataclasses.astuple(c) for c in jpl._chains_of(
        jpl.build_seq_table(buf, jparse(buf, lz4tpu.FOR_ALL),
                            lz4tpu.FOR_ALL, data))]
    assert chains_t == chains_j


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 1023, 70_000])
def test_xxh32_equal(n):
    data = _rand(n, 40 + n % 7)
    want = lz4tpu.xxh32(data)
    assert lz4tpu_torch.xxh32(data) == want
    assert tnative.native_xxh32(data) == jnative.native_xxh32(data) == want
    h = lz4tpu_torch.XXHash32(seed=9).update(data[:n // 3]).update(
        data[n // 3:])
    assert h.final() == lz4tpu.XXHash32(seed=9).update(data).final()
    assert tnative.NativeXXH32().update(data).final() == want


def test_native_engine_is_the_ports_own():
    assert tnative.available()
    assert tnative._get() is not jnative._get()
    assert "lz4tpu_torch" in tnative._SRC


@pytest.mark.parametrize("name", sorted(COMPRESS_CASES))
def test_decompress_host_bytes_equal(name):
    data = lz4tpu.compress(PAYLOAD, **COMPRESS_CASES[name])
    assert lz4tpu_torch.decompress_host(data) == PAYLOAD
    assert lz4tpu_torch.decompress(data, backend="host") == PAYLOAD
    dst = np.zeros(len(PAYLOAD) + 8, np.uint8)
    assert lz4tpu_torch.decompress_into(data, dst) == len(PAYLOAD)
    assert dst[:len(PAYLOAD)].tobytes() == PAYLOAD


def test_multi_frame_host_decode_equal():
    data = _frames()
    assert lz4tpu_torch.decompress_host(data) == lz4tpu.decompress_host(data)


@pytest.mark.parametrize("chunk", [1, 7, 4096])
def test_streaming_decompressor_equal(chunk):
    data = lz4tpu.compress(PAYLOAD[:50_000], block_max_code=4,
                           block_checksum=True)
    outs = []
    for mod in (lz4tpu_torch, lz4tpu):
        ctx = mod.Decompressor(mod.FOR_ALL)
        out = bytearray()
        arr = np.frombuffer(data, np.uint8)
        pos = 0
        while pos < arr.size:
            got, piece = ctx.update(arr[pos:pos + chunk])
            out += piece
            pos += got
        outs.append((bytes(out), ctx.end_of_frame.name))
    assert outs[0] == outs[1]
    assert outs[0][0] == PAYLOAD[:50_000]


def test_version_equals_the_jax_package():
    assert lz4tpu_torch.__version__ == lz4tpu.__version__
    assert "__version__" in lz4tpu_torch.__all__


def test_min_buffer_size_and_constants_equal():
    for res in ("FOR_ALL", "FOR_MODERN", "FOR_LEGACY"):
        assert (lz4tpu_torch.min_buffer_size(getattr(lz4tpu_torch, res))
                == lz4tpu.min_buffer_size(getattr(lz4tpu, res)))
    assert lz4tpu_torch.HISTORY_SIZE == lz4tpu.HISTORY_SIZE
    assert ([r.name for r in lz4tpu_torch.Reservation]
            == [r.name for r in lz4tpu.Reservation])
    assert lz4tpu_torch.hex8(0xAB) == lz4tpu.hex8(0xAB)
    assert lz4tpu_torch.hex32(0xDEADBEEF) == lz4tpu.hex32(0xDEADBEEF)


def _corruptions():
    blob = PAYLOAD[:80_000]
    data = lz4tpu.compress(blob, block_checksum=True, block_max_code=4)
    plain = lz4tpu.compress(blob)

    def flip(src, at, bit):
        b = bytearray(src)
        b[at] ^= bit
        return bytes(b)

    return {
        "block_checksum": flip(data, 200, 0x40),
        "content_checksum": flip(plain, len(plain) - 1, 0x01),
        "truncated": data[:-37],
        "truncated_header": data[:5],
        "header_checksum": flip(data, 5, 0x10),
        "bad_magic": b"\x00\x01\x02\x03" + data[4:],
        "bad_version": flip(data, 4, 0x80),
        "reserved_bit": flip(data, 4, 0x02),
        "token_damage": flip(plain, 9, 0xF0),
        "offset_zero": flip(plain, len(plain) // 2, 0xFF),
        "trailing_garbage": data + b"\x01\x02\x03",
    }


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_host_error_parity_by_name_and_message(name):
    data = _corruptions()[name]
    results = []
    for mod in (lz4tpu_torch, lz4tpu):
        try:
            out = mod.decompress_host(data)
        except mod.Lz4Error as e:
            results.append((type(e).__name__, str(e), e.ada_image()))
        else:
            results.append(("ok", out))
    assert results[0] == results[1]


def test_reservation_error_parity():
    data = lz4tpu.compress(bytes(300_000), block_max_code=7)
    results = []
    for mod in (lz4tpu_torch, lz4tpu):
        with pytest.raises(mod.Lz4Error) as ei:
            mod.decompress_host(data, mod.Reservation.SZ_64_KIB)
        results.append((type(ei.value).__name__, str(ei.value)))
    assert results[0] == results[1]
    assert results[0][0] == "TooLittleMemory"


def test_exception_classes_are_the_ports_own():
    for name in ("Lz4Error", "ChecksumError", "DataCorruption",
                 "NotSupported", "TooFewHeaderBytes", "TooLittleMemory"):
        ours, theirs = getattr(lz4tpu_torch, name), getattr(lz4tpu, name)
        assert ours is not theirs and ours.__name__ == theirs.__name__
        assert ours.__module__ == "lz4tpu_torch.errors"
        if name != "Lz4Error":
            assert issubclass(ours, lz4tpu_torch.Lz4Error)
