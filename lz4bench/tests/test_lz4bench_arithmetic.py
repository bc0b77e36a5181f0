"""The readers' arithmetic on made-up samples, the frozen encoder and the
plain reference against each other."""

import json
import pathlib
import struct

import numpy as np
import pytest

from lz4bench import encoder, harness, readers, reference, tracing

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _window(lat, raw, seconds, setup=1.0):
    return harness.Window(seconds=seconds, setup_s=setup, lat=list(lat),
                          raw=list(raw))


def test_rate_is_all_bytes_over_all_the_window():
    win = _window([0.1, 0.3, 0.2], [10**9, 10**9, 0], seconds=0.8)
    # the failed request (0 bytes) and the time between requests count
    assert readers.rate_gbps(win) == pytest.approx(2.0 / 0.8)
    assert readers.rate_gbps(_window([], [], 0.0)) is None


def _trace(requests, busy=None, window=None,
           kind="NVIDIA H100 80GB HBM3"):
    tr = tracing.Trace("decode", kind, requests=requests)
    tr.busy_s, tr.window_s = busy, window
    return tr


def test_roofline_counts_bytes_once_at_the_peak():
    reqs = [tracing.TracedRequest(raw=3 * 10**9, comp=10**9 // 2,
                                  seconds=1.0, cpu_s=0.5, spans={},
                                  device_s=0.0035),
            tracing.TracedRequest(raw=3 * 10**9, comp=10**9 // 2,
                                  seconds=1.0, cpu_s=0.5, spans={},
                                  device_s=0.0035)]
    # 7e9 B at 3.35e12 B/s = 2.0896 ms of 7 ms
    assert readers.roofline(_trace(reqs)) == pytest.approx(
        100 * 7e9 / 3.35e12 / 0.007)
    assert readers.roofline(_trace(reqs, kind="another card")) is None
    reqs[0].device_s = None
    assert readers.roofline(_trace(reqs)) is None


def test_idle_share_span_and_cpu_readings():
    reqs = [tracing.TracedRequest(10, 5, 1.0, 0.25, {"plan": 0.1}),
            tracing.TracedRequest(10, 5, 1.0, 0.75, {"plan": 0.3,
                                                     "scan": 0.2})]
    tr = _trace(reqs, busy=0.25, window=2.0)
    assert readers.idle_share(tr) == pytest.approx(87.5)
    assert readers.span_ms(tr, "plan") == pytest.approx(200.0)
    assert readers.span_ms(tr, "scan") == pytest.approx(100.0)
    assert readers.span_ms(tr, "verify") is None
    assert readers.host_cpu_ms(tr) == pytest.approx(500.0)
    assert readers.ratio(tr) == pytest.approx(50.0)
    assert readers.idle_share(_trace(reqs)) is None


def test_profile_reading_keeps_to_the_requests():
    """Device operations and gaps are read inside the request spans only;
    each operation is placed by the span it overlaps most."""
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(dev, lo, hi, name):
        return types.SimpleNamespace(device_type=dev, name=name,
                                     time_range=types.SimpleNamespace(
                                         start=lo, end=hi))

    events = [ev(cpu, 0, 100, tracing.REQUEST_SPAN),
              ev(cpu, 200, 400, tracing.REQUEST_SPAN),
              ev(cpu, 0, 60, "plan"), ev(cpu, 250, 300, "verify"),
              ev(cuda, 60, 90, "kernel_a"), ev(cuda, 120, 180, "check_op"),
              ev(cuda, 250, 300, "kernel_b"), ev(cuda, 290, 310, "kernel_a")]
    reqs = [tracing.TracedRequest(10, 5, 1.0, 0.0, {}),
            tracing.TracedRequest(10, 5, 1.0, 0.0, {})]
    tr = _trace(reqs)
    tracing._read_profile(types.SimpleNamespace(events=lambda: events), tr,
                          {"plan", "verify", tracing.CHECK_SPAN})
    assert tr.window_s == pytest.approx(300e-6)
    assert tr.busy_s == pytest.approx(90e-6)        # 30 + 60, check_op out
    assert [r.device_s for r in reqs] == pytest.approx([30e-6, 70e-6])
    assert dict(tr.breakdown["device_ops"]) == {
        "kernel_a": pytest.approx(50e-6), "kernel_b": pytest.approx(50e-6)}
    req = tracing.REQUEST_SPAN
    assert tr.breakdown["idle_gaps"] == [
        [req, pytest.approx(90e-6)], ["plan", pytest.approx(60e-6)],
        [req, pytest.approx(50e-6)], [req, pytest.approx(10e-6)]]


def test_merge_of_device_intervals():
    assert tracing._merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3],
                                                                [5, 8]]


def test_peaks_are_the_data_sheet_numbers():
    peaks = json.loads((ROOT / "lz4bench/peaks.json").read_text())
    assert peaks["NVIDIA H100 80GB HBM3"]["hbm_bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("data", [b"", b"a", b"abcd" * 3, bytes(range(256)),
                                  b"lz4bench" * 1001])
def test_the_two_xxh32_agree(data):
    arr = np.frombuffer(data, np.uint8)
    assert reference.xxh32(data) == encoder.xxh32(arr)


def test_xxh32_known_values():
    assert reference.xxh32(b"") == 0x02CC5D05
    assert reference.xxh32(b"a") == 0x550D7456
    assert reference.xxh32(b"abc") == 0x32D153FF


LINKED = {"block_max_code": 4, "block_independence": False,
          "content_checksum": True, "block_checksum": False,
          "content_size": False}
INDEPENDENT = dict(LINKED, block_independence=True)


@pytest.mark.parametrize("corpus", ["words", "frag", "zeros", "urandom"])
@pytest.mark.parametrize("flags", [LINKED, INDEPENDENT,
                                   dict(LINKED, block_checksum=True)])
def test_frozen_frames_read_back_by_the_reference(corpus, flags):
    raw = harness.corpus(corpus).make(200_000, harness.generator(
        9, corpus, 0))
    frame = encoder.compress_frame(raw, flags, 6)
    got = reference.read_frame(frame)
    assert got.content == raw.tobytes()
    assert got.flags == flags
    assert reference.check_frame(frame, raw, flags, encoder.xxh32(raw)) == {
        "header": 0, "content": 0, "checksum": 0}
    assert reference.decode_unverified(frame) == raw.tobytes()


def test_the_check_sees_each_fault():
    raw = harness.corpus("words").make(300_000, harness.generator(
        4, "words", 0))
    h = encoder.xxh32(raw)
    frame = encoder.compress_frame(raw, LINKED, 6)
    # an independent frame whose blocks reach back is wrong
    assert reference.check_frame(frame, raw, INDEPENDENT, h)["header"] == 1
    flipped = bytearray(frame)
    flipped[-1] ^= 1
    assert reference.check_frame(bytes(flipped), raw, LINKED, h) == {
        "header": 0, "content": 0, "checksum": 1}
    body = bytearray(frame)
    body[len(body) // 2] ^= 0x40
    assert reference.check_frame(bytes(body), raw, LINKED, h)["content"] == 1
    unsummed = encoder.compress_frame(raw, dict(LINKED,
                                                content_checksum=False), 6)
    assert reference.check_frame(unsummed, raw, LINKED, h) == {
        "header": 1, "content": 0, "checksum": 1}
    assert reference.check_frame(frame[:len(frame) // 2], raw, LINKED,
                                 h)["content"] == 1


def test_a_match_before_an_independent_block_is_refused():
    raw = np.frombuffer(b"0123456789abcdef" * 8192, np.uint8)   # 128 KiB
    frame = encoder.compress_frame(raw, LINKED, 6)              # 64 KiB
    hdr = bytearray(frame)
    hdr[4] |= 0x20                                              # B.Indep
    hdr[6] = (reference.xxh32(bytes(hdr[4:6])) >> 8) & 0xFF
    with pytest.raises(reference.FrameError):
        reference.read_frame(bytes(hdr))


def test_overlapping_match_repeats_its_pattern():
    # literals "ab", then a match of 7 at offset 2; last sequence literal-only
    block = bytes([0x23]) + b"ab" + struct.pack("<H", 2) + bytes([0x50]) \
        + b"wxyz!"
    out = bytearray()
    reference.decode_block(block, out, 0)
    assert bytes(out) == b"ababababa" + b"wxyz!"


def test_frozen_encoder_is_frozen():
    """The decode inputs are these frames: a change to the frozen copy is a
    change of the benchmark (the frame below is seed 1's first words
    request at 64 KiB, linked 64 KiB blocks)."""
    raw = harness.corpus("words").make(1 << 16, harness.generator(
        1, "words", 0))
    frame = encoder.compress_frame(raw, LINKED, 6)
    assert (len(frame), encoder.xxh32(np.frombuffer(frame, np.uint8))) == \
        FROZEN_64K


FROZEN_64K = (31996, 0xE4D63DE8)
