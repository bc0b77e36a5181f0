"""The port's device xxh32 (plain versions, on the CPU) against the JAX
package's Pallas kernels run in interpret mode, and
``decompress_to_device(verify="device")`` against
``lz4tpu.decompress_to_device(..., interpret=True, verify="device")``.
Inputs are seeded numpy; tolerance 0 (32-bit integers and bytes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4tpu
import lz4tpu.pipeline as jpl
import lz4tpu_torch
import lz4tpu_torch.pipeline as tpl
from lz4tpu.device import xxh32_pallas as jxx
from lz4tpu_torch import _kernels
from lz4tpu_torch.device import xxh32_cuda as txx

RNG = np.random.default_rng(42)
DATA = RNG.integers(0, 256, 40_000, dtype=np.uint8)


def _frag_text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    frags = [rng.integers(32, 127, int(rng.integers(3, 9)),
                          dtype=np.uint8).tobytes() for _ in range(4096)]
    picks = rng.integers(0, 4096, n // 5 + 16)
    return b"".join(frags[i] for i in picks)[:n]


@pytest.mark.parametrize("n", [0, 5, 16, 31, 100, 4096, 10000])
def test_xxh32_device_matches_jax_kernel(n):
    data = DATA[:n]
    want = jxx.xxh32_device(data, interpret=True)
    assert txx.xxh32_device(data, device="cpu") == want == lz4tpu.xxh32(
        data.tobytes())
    assert txx.xxh32_device(torch.from_numpy(data.copy()),
                            device="cpu") == want


@pytest.mark.parametrize("tail", range(16))
def test_xxh32_of_device_array_odd_lo_every_tail(tail, monkeypatch):
    monkeypatch.setattr(jxx, "_SEG_BYTES", 1 << 15)
    monkeypatch.setattr(jxx, "_SMALL_FETCH", 1 << 10)
    lo = 7 + tail
    hi = lo + 16 * 150 + tail
    want = jxx.xxh32_of_device_array(jnp.asarray(DATA), lo, hi,
                                     interpret=True)
    got = txx.xxh32_of_device_array(torch.from_numpy(DATA), lo, hi)
    assert got == want == lz4tpu.xxh32(DATA[lo:hi].tobytes())


@pytest.mark.parametrize("lo,hi", [(0, 40_000), (7, 39_003),
                                   (100, 100 + (1 << 15)),
                                   (5, 5 + (1 << 15) + 13), (0, 16), (3, 3),
                                   (9, 20), (11, 11 + 15)])
def test_xxh32_of_device_array_matches_jax_segment_chain(lo, hi,
                                                         monkeypatch):
    """The JAX package chains fixed 32 KiB segments (shrunk as its own
    test does); the port covers the range in one call."""
    monkeypatch.setattr(jxx, "_SEG_BYTES", 1 << 15)
    monkeypatch.setattr(jxx, "_SMALL_FETCH", 1 << 14)
    want = jxx.xxh32_of_device_array(jnp.asarray(DATA), lo, hi,
                                     interpret=True)
    assert txx.xxh32_of_device_array(torch.from_numpy(DATA), lo, hi) == want


def test_every_range_with_a_stripe_goes_through_the_stream_function(
        monkeypatch):
    """No size threshold sends a range to the host: only a range with no
    whole stripe (under 16 bytes) is hashed there, as its own tail."""
    calls = []
    real = txx.xxh32_stream
    monkeypatch.setattr(
        txx, "xxh32_stream",
        lambda *a: calls.append(a[1:3]) or real(*a))
    arr = torch.from_numpy(DATA)
    assert txx.xxh32_of_device_array(arr, 3, 3 + 15) == lz4tpu.xxh32(
        DATA[3:3 + 15].tobytes())
    assert calls == []
    for n in (16, 17, 4095, 4096):
        assert txx.xxh32_of_device_array(arr, 3, 3 + n) == lz4tpu.xxh32(
            DATA[3:3 + n].tobytes())
    assert calls == [(3, 1), (3, 1), (3, 255), (3, 256)]
    assert not hasattr(txx, "SMALL_FETCH")


def test_stream_state_carries_between_packages_in_two_halves():
    """K7's carried state: the first half hashed by the JAX kernel and
    the second by the port (and the other way round) equals one pass."""
    n_str, lo = 300, 5
    body = DATA[lo:lo + 16 * n_str]
    half = 128
    seg = jxx._SEG_BYTES

    def jax_state(chunk, state_np):
        padded = np.zeros(seg, np.uint8)
        padded[:chunk.size] = chunk
        out = jxx._lane_state_segment(
            jnp.asarray(padded), jnp.full((1,), chunk.size // 16, jnp.int32),
            jnp.asarray(state_np), interpret=True)
        return np.asarray(jax.device_get(out))

    seed_np = txx.lane_state_to_numpy(txx.seed_state("cpu"))
    arr = torch.from_numpy(DATA)
    whole = txx.xxh32_stream(arr, lo, n_str, txx.seed_state("cpu"))
    assert np.array_equal(jax_state(body, seed_np),
                          txx.lane_state_to_numpy(whole))
    # JAX first, port second
    mid = txx.lane_state_from_numpy(jax_state(body[:16 * half], seed_np),
                                    "cpu")
    assert torch.equal(
        txx.xxh32_stream(arr, lo + 16 * half, n_str - half, mid), whole)
    # port first, JAX second
    mid = txx.xxh32_stream(arr, lo, half, txx.seed_state("cpu"))
    assert np.array_equal(
        jax_state(body[16 * half:], txx.lane_state_to_numpy(mid)),
        txx.lane_state_to_numpy(whole))
    tail = DATA[lo + 16 * n_str:lo + 16 * n_str + 9].tobytes()
    assert (txx._finalize(txx.lane_state_to_numpy(whole), 16 * n_str + 9,
                          tail)
            == jxx._finalize(txx.lane_state_to_numpy(whole), 16 * n_str + 9,
                             tail)
            == lz4tpu.xxh32(DATA[lo:lo + 16 * n_str + 9].tobytes()))


def test_stream_edge_cases():
    arr = torch.from_numpy(DATA)
    seed = txx.seed_state("cpu")
    assert torch.equal(txx.xxh32_stream(arr, 9, 0, seed), seed)
    with pytest.raises(ValueError, match="leave the array"):
        txx.xxh32_stream(arr, DATA.size - 15, 1, seed)
    with pytest.raises(ValueError, match="leave the array"):
        txx.xxh32_stream(arr, -1, 1, seed)
    with pytest.raises(ValueError, match="lane state"):
        txx.lane_state_from_numpy(np.zeros(3, np.int32), "cpu")
    with pytest.raises(ValueError, match="lane state"):
        txx.lane_state_to_numpy(torch.zeros(4, dtype=torch.int64))
    assert txx.xxh32_of_device_array(arr, 5, 5) == lz4tpu.xxh32(b"")
    assert txx.xxh32_of_device_array(arr, 5, 2) == lz4tpu.xxh32(b"")


def test_blocks_device_matches_jax_kernel():
    """Real block layouts plus sub-stripe blocks and blocks ending at
    unaligned offsets, as the JAX package's own test hashes them."""
    data = lz4tpu.compress(_frag_text(90_000, 3), block_max_code=4,
                           block_checksum=True)
    buf = np.frombuffer(data, np.uint8)
    parsed = lz4tpu.frame.parse_frames(buf, lz4tpu.FOR_ALL)
    offs = [b.comp_off for f in parsed.frames for b in f.blocks]
    lens = [b.comp_len for f in parsed.frames for b in f.blocks]
    offs += [0, 7, len(data) - 3, 11]
    lens += [3, 15, 3, 0]
    want = jxx.xxh32_blocks_device(buf, offs, lens, interpret=True)
    got = txx.xxh32_blocks_device(buf, offs, lens, device="cpu")
    assert got == want == [lz4tpu.xxh32(data[o:o + n])
                           for o, n in zip(offs, lens)]
    assert txx.xxh32_blocks_device(torch.from_numpy(buf.copy()), offs,
                                   lens) == want
    assert txx.xxh32_blocks_device(buf, [], [], device="cpu") == []
    with pytest.raises(ValueError, match="leaves the compressed buffer"):
        txx.xxh32_blocks_device(buf, [len(data) - 2], [3], device="cpu")


def test_blocks_lane_states_match_jax_kernel():
    offs, lens = [3, 1000, 20_001], [16 * 40, 16 * 7 + 5, 16 * 129]
    states = txx.xxh32_blocks(torch.from_numpy(DATA), torch.tensor(offs),
                              torch.tensor(lens))
    for row, o, n in zip(states, offs, lens):
        one = txx.xxh32_stream(torch.from_numpy(DATA), o, n // 16,
                               txx.seed_state("cpu"))
        assert torch.equal(row, one)


def test_seed_state_is_shared_and_left_untouched():
    want = np.array([jxx.P1 + jxx.P2, jxx.P2, 0, -jxx.P1],
                    np.int64) & 0xFFFFFFFF
    seed = txx.seed_state("cpu")
    assert seed is txx.seed_state("cpu")
    arr = torch.from_numpy(DATA)
    out = txx.xxh32_stream(arr, 3, 50, seed)
    assert out is not seed
    assert txx.xxh32_stream(arr, 3, 0, seed) is not seed
    txx.xxh32_of_device_array(arr, 1, 999)
    txx.xxh32_device(DATA[:777], device="cpu")
    got = txx.lane_state_to_numpy(txx.seed_state("cpu")).astype(np.int64)
    assert np.array_equal(got & 0xFFFFFFFF, want)
    assert np.array_equal(
        txx.lane_state_to_numpy(txx.seed_state("cpu", seed=5)).astype(
            np.int64) & 0xFFFFFFFF, (want + 5) & 0xFFFFFFFF)


def test_cpu_wrappers_launch_nothing():
    before = dict(_kernels.LAUNCHES)
    arr = torch.from_numpy(DATA)
    txx.xxh32_stream(arr, 0, 10, txx.seed_state("cpu"))
    txx.xxh32_blocks(arr, torch.tensor([0]), torch.tensor([64]))
    assert _kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# verify="device"
# ---------------------------------------------------------------------------

def _port(data, **kw) -> bytes:
    return lz4tpu_torch.decompress_to_device(
        data, device="cpu", **kw).numpy().tobytes()


def _jax(data, **kw) -> bytes:
    return np.asarray(jpl.decompress_to_device(
        data, interpret=True, **kw)).tobytes()


VERIFY_CASES = {
    "content_only": (lambda: _frag_text(30_000, 5), {}),
    "block_checksums": (lambda: _frag_text(40_000, 6),
                        dict(block_checksum=True, block_max_code=4)),
    "independent": (lambda: _frag_text(40_000, 7),
                    dict(block_checksum=True, block_max_code=4,
                         block_independence=True)),
    "zeros": (lambda: bytes(70_000),
              dict(block_checksum=True, content_size=True)),
    "stored": (lambda: np.random.default_rng(8).integers(
        0, 256, 20_000, dtype=np.uint8).tobytes(),
        dict(block_checksum=True)),
    "no_checksums": (lambda: _frag_text(20_000, 9),
                     dict(content_checksum=False)),
    "legacy": (lambda: _frag_text(20_000, 10), dict(frame_format="legacy")),
    "empty": (lambda: b"", {}),
}


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_device_matches_jax(name):
    make, kw = VERIFY_CASES[name]
    blob = make()
    data = lz4tpu.compress(blob, **kw)
    assert _port(data, verify="device") == blob == _jax(data,
                                                        verify="device")


def test_verify_device_multi_frame():
    a, b = _frag_text(20_000, 11), bytes(30_000)
    data = (lz4tpu.compress(a, block_checksum=True, block_max_code=4)
            + lz4tpu.compress(b) + lz4tpu.compress(a[:5000],
                                                   content_checksum=False))
    assert _port(data, verify="device") == a + b + a[:5000] == _jax(
        data, verify="device")


def test_verify_device_block_checksums():
    """``_verify_checksums_device`` with a staged compressed buffer runs
    block checksums through the batched function, and without one
    through the native host hash; both catch a corrupted payload."""
    payload = b"the quick brown fox jumps over the lazy dog " * 400
    data = lz4tpu.compress(payload, block_checksum=True)
    buf = np.frombuffer(data, np.uint8)
    parsed = tpl.parse_frames(buf, lz4tpu_torch.FOR_ALL)
    table = tpl.build_seq_table(buf, parsed, lz4tpu_torch.FOR_ALL, data)
    out = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    for staged in (True, False):
        comp = torch.from_numpy(buf.copy()) if staged else None
        tpl._verify_checksums_device(buf, parsed, out, table, comp_dev=comp)
    bad = bytearray(data)
    bad[25] ^= 0x40
    bbuf = np.frombuffer(bytes(bad), np.uint8)
    for staged in (True, False):
        comp = torch.from_numpy(bbuf.copy()) if staged else None
        with pytest.raises(lz4tpu_torch.ChecksumError) as et:
            tpl._verify_checksums_device(bbuf, parsed, out, table,
                                         comp_dev=comp)
        with pytest.raises(lz4tpu.ChecksumError) as ej:
            jpl._verify_checksums_device(
                bbuf, lz4tpu.frame.parse_frames(buf, lz4tpu.FOR_ALL),
                jnp.asarray(np.frombuffer(payload, np.uint8)),
                jpl.build_seq_table(
                    buf, lz4tpu.frame.parse_frames(buf, lz4tpu.FOR_ALL),
                    lz4tpu.FOR_ALL, data),
                interpret=True, comp_dev=jnp.asarray(bbuf) if staged
                else None)
        assert str(et.value) == str(ej.value)


def test_verify_device_stages_comp_only_for_block_checksums(monkeypatch):
    seen = []
    real = tpl._verify_checksums_device

    def spy(buf, parsed, out_dev, table, comp_dev=None):
        seen.append(comp_dev is not None)
        return real(buf, parsed, out_dev, table, comp_dev=comp_dev)

    monkeypatch.setattr(tpl, "_verify_checksums_device", spy)
    blob = _frag_text(20_000, 12)
    _port(lz4tpu.compress(blob), verify="device")
    _port(lz4tpu.compress(blob, block_checksum=True), verify="device")
    assert seen == [False, True]


def test_verify_device_multiframe_fault_order():
    """Content-checksum fault in frame 1 + block-checksum fault in frame
    2 raises frame 1's error from both verify modes and both packages."""
    f1 = bytearray(lz4tpu.compress(b"alpha " * 300, content_checksum=True,
                                   block_checksum=False))
    f2 = bytearray(lz4tpu.compress(b"beta " * 300, content_checksum=False,
                                   block_checksum=True))
    f1[-2] ^= 0x01          # frame 1 content checksum byte
    f2[25] ^= 0x40          # frame 2 block payload -> block checksum
    data = bytes(f1 + f2)
    msgs = {}
    for mode in ("host", "device"):
        with pytest.raises(lz4tpu_torch.ChecksumError) as et:
            lz4tpu_torch.decompress_to_device(data, device="cpu",
                                              verify=mode)
        with pytest.raises(lz4tpu.ChecksumError) as ej:
            jpl.decompress_to_device(data, interpret=True, verify=mode)
        assert type(et.value).__name__ == type(ej.value).__name__
        assert str(et.value) == str(ej.value)
        msgs[mode] = str(et.value)
    assert msgs["host"] == msgs["device"]
    assert "ontent" in msgs["host"]


def test_verify_device_block_fault_before_content_fault_in_one_frame():
    blob = _frag_text(30_000, 13)
    data = bytearray(lz4tpu.compress(blob, block_checksum=True,
                                     block_max_code=4))
    data[40] ^= 0x04         # block 0 payload
    data[-1] ^= 0x01         # content checksum
    results = []
    for fn in (lambda: lz4tpu_torch.decompress_to_device(
            bytes(data), device="cpu", verify="device"),
            lambda: jpl.decompress_to_device(bytes(data), interpret=True,
                                             verify="device"),
            lambda: lz4tpu.decompress_host(bytes(data))):
        try:
            fn()
        except Exception as e:      # both packages' Lz4Error families
            results.append((type(e).__name__, str(e)))
    assert len(results) == 3 and results[0] == results[1] == results[2]
    assert "Declared checksum" in results[0][1]


def _mono_payload(size: int, seed: int = 3) -> bytes:
    """An 8 KiB block of printable bytes repeated with 60 bytes changed
    each time: one fused chain of long matches at offset 8192."""
    rng = np.random.default_rng(seed)
    base = rng.integers(32, 127, 8192, dtype=np.uint8)
    chunks = []
    for _ in range(size // 8192 + 2):
        b = base.copy()
        idx = rng.integers(0, 8192, 60)
        b[idx] = rng.integers(32, 127, 60)
        chunks.append(b.tobytes())
    return b"".join(chunks)[:size]


def _corruptions():
    blob = _frag_text(30_000, 14)
    data = lz4tpu.compress(blob, block_checksum=True, block_max_code=4)
    flip = bytearray(data)
    flip[200] ^= 0x40
    content = bytearray(lz4tpu.compress(blob))
    content[-1] ^= 0x01
    mono = bytearray(lz4tpu.compress(_mono_payload(160 * 1024, seed=8),
                                     block_max_code=7))
    mono[-1] ^= 0x01
    return {"block_checksum": bytes(flip),
            "content_checksum": bytes(content),
            "mono_content_checksum": bytes(mono),
            "truncated": data[:-37],
            "bad_magic": b"\x00\x01\x02\x03" + data[4:]}


@pytest.mark.parametrize("name", sorted(_corruptions()))
def test_verify_device_error_parity(name):
    data = _corruptions()[name]
    with pytest.raises(lz4tpu.Lz4Error) as ej:
        jpl.decompress_to_device(data, interpret=True, verify="device")
    with pytest.raises(lz4tpu_torch.Lz4Error) as et:
        lz4tpu_torch.decompress_to_device(data, device="cpu",
                                          verify="device")
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)
