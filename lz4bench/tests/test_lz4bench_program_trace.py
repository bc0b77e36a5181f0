"""The program-span readings (``lz4bench.program_trace``) on made-up
timelines, the profiler's reading with and without the program's ranges,
and a program without ``lz4tpu_torch.trace``.  CPU only."""

import json
import sys
import types

import pytest
import torch

from lz4bench import harness, program_trace as pgt, tracing

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _decode_trace():
    """Request 0 (0-1000 us): idle 0-100 under the prep spans, 250-300
    under engines and its staging copy, 480-600 under a sparse chain
    nested in engines, 700-790 under verify, 850-1000 under the request
    span alone.  Request 1 (2000-2500 us): busy throughout."""
    spans0 = sorted([
        (0, 1000, "decode"), (0, 40, "decode.parse"),
        (40, 90, "decode.scan"), (90, 100, "decode.plan"),
        (250, 700, "decode.engines"), (260, 300, "stage"),
        (265, 295, "stage.pin"), (480, 600, "decode.engine.sparse"),
        (700, 800, "decode.verify")])
    return pgt.ProgramTrace(
        requests=[(0, 1000), (2000, 2500)],
        spans=[spans0, [(2000, 2500, "decode")]],
        busy=[[(100, 250), (300, 480), (600, 700), (790, 850)],
              [(2000, 2500)]],
        h2d_bytes=150, comp_bytes=100)


def test_idle_intervals_are_the_request_less_the_busy_time():
    pt = _decode_trace()
    assert pgt.idle(pt, 0) == [(0, 100), (250, 300), (480, 600), (700, 790),
                               (850, 1000)]
    assert pgt.idle(pt, 1) == []


def test_decode_readings():
    pt = _decode_trace()
    got = {name: fn(pt) for name, fn in pgt.READINGS["decode"].items()}
    assert got == {
        "prep_ms.decode": pytest.approx(0.100 / 2),   # a mean of 2 requests
        "pin_ms.decode": pytest.approx(0.030 / 2),
        "staged_share.decode": pytest.approx(150.0),
        # 50 us under engines and its copy, 120 under the nested chain
        "engines_idle_ms.decode": pytest.approx(0.170 / 2),
        # all but the 150 us under the request span alone, of 510
        "idle_named.decode": pytest.approx(100 * 360 / 510),
    }


def test_idle_by_span_and_the_longest_gaps():
    pt = _decode_trace()
    by = pgt.idle_by_span(pt)
    assert by["decode"] == pytest.approx(0.510 / 2)
    assert by["decode.engine.sparse"] == pytest.approx(0.120 / 2)
    assert by["stage"] == pytest.approx(0.040 / 2)
    assert by["stage.pin"] == pytest.approx(0.030 / 2)
    assert by["decode.verify"] == pytest.approx(0.090 / 2)
    # each gap split by the innermost span over each part
    assert pgt.longest_gaps(pt) == [
        [pytest.approx(0.150), {"decode": pytest.approx(0.150)}],
        [pytest.approx(0.120), {"decode.engine.sparse": pytest.approx(0.120)}],
        [pytest.approx(0.100), {"decode.scan": pytest.approx(0.050),
                                "decode.parse": pytest.approx(0.040),
                                "decode.plan": pytest.approx(0.010)}],
        [pytest.approx(0.090), {"decode.verify": pytest.approx(0.090)}],
        [pytest.approx(0.050), {"stage.pin": pytest.approx(0.030),
                                "decode.engines": pytest.approx(0.010),
                                "stage": pytest.approx(0.010)}]]
    assert pgt.longest_gaps(pt, top=1) == pgt.longest_gaps(pt)[:1]
    self_ms = pgt.idle_self_by_span(pt)
    assert self_ms == {k: pytest.approx(v / 2) for k, v in {
        "decode": 0.150, "decode.engine.sparse": 0.120, "decode.scan": 0.050,
        "decode.parse": 0.040, "decode.plan": 0.010, "decode.verify": 0.090,
        "stage.pin": 0.030, "decode.engines": 0.010, "stage": 0.010}.items()}
    # the split covers the idle time once
    assert sum(self_ms.values()) == pytest.approx(by["decode"])


def test_encode_readings():
    pt = pgt.ProgramTrace(
        requests=[(0, 100)],
        spans=[sorted([(0, 100, "encode"), (0, 90, "encode.block"),
                       (10, 40, "encode.issue"), (12, 20, "encode.sort"),
                       (40, 70, "encode.fetch"), (70, 90, "encode.splice")])],
        busy=[[(15, 60)]])
    got = {name: fn(pt) for name, fn in pgt.READINGS["encode"].items()}
    # idle 0-15 (issue 10-15 under block), 60-100 (fetch 60-70, splice
    # 70-90, the request alone 90-100): 45 of 55 us named
    assert got == {"issue_ms.encode": pytest.approx(0.030),
                   "fetch_ms.encode": pytest.approx(0.030),
                   "idle_named.encode": pytest.approx(100 * 45 / 55)}


def test_no_recorded_span_reads_nothing():
    pt = pgt.ProgramTrace(requests=[(0, 10)], spans=[[]], busy=[[]],
                          h2d_bytes=5, comp_bytes=5)
    for cell in pgt.READINGS.values():
        assert {fn(pt) for fn in cell.values()} == {None}
    assert pgt.idle_by_span(pt) == {} and pgt.longest_gaps(pt) == [
        [pytest.approx(0.010), {"request": pytest.approx(0.010)}]]


def _ev(dev, lo, hi, name, annotation=False):
    e = types.SimpleNamespace(device_type=dev, name=name,
                              time_range=types.SimpleNamespace(start=lo,
                                                               end=hi))
    if annotation:
        e.is_user_annotation = True
    return e


def _events(program: bool) -> list:
    """Two requests, the benchmark's spans, kernels, a check between; with
    ``program``, the program's ranges on the host and, as the profiler
    puts them, as annotations on the card's timeline."""
    events = [_ev(CPU, 0, 100, tracing.REQUEST_SPAN),
              _ev(CPU, 200, 400, tracing.REQUEST_SPAN),
              _ev(CPU, 0, 60, "plan"), _ev(CPU, 250, 300, "verify"),
              _ev(CUDA, 60, 90, "kernel_a"), _ev(CUDA, 120, 180, "check_op"),
              _ev(CUDA, 250, 300, "kernel_b"),
              _ev(CUDA, 290, 310, "kernel_a")]
    if program:
        for lo, hi, name in [(0, 100, "decode"), (0, 50, "decode.scan"),
                             (50, 95, "decode.engines"),
                             (200, 400, "decode"),
                             (240, 320, "decode.verify")]:
            events.append(_ev(CPU, lo, hi, pgt.PREFIX + name))
            events.append(_ev(CUDA, lo + 2, hi - 2, pgt.PREFIX + name,
                              annotation=True))
    return events


def _read(events):
    reqs = [tracing.TracedRequest(10, 5, 1.0, 0.0, {}),
            tracing.TracedRequest(10, 5, 1.0, 0.0, {})]
    tr = tracing.Trace("decode", "NVIDIA H100 80GB HBM3", requests=reqs)
    tracing._read_profile(types.SimpleNamespace(events=lambda: events), tr,
                          {"plan", "verify", tracing.CHECK_SPAN})
    return tr


def test_program_ranges_change_no_accepted_reading():
    old, new = _read(_events(False)), _read(_events(True))
    assert (new.busy_s, new.window_s) == (old.busy_s, old.window_s)
    assert [r.device_s for r in new.requests] == [
        r.device_s for r in old.requests]
    assert new.breakdown == old.breakdown
    assert old.busy_s == pytest.approx(90e-6)


def test_collect_reads_the_program_ranges_and_no_annotation():
    names = {"plan", "verify", tracing.CHECK_SPAN}
    pt = pgt.collect(_events(True), names)
    assert pt.requests == [(0, 100), (200, 400)]
    assert pt.busy == [[[60, 90]], [[250, 310]]]
    assert [n for _lo, _hi, n in pt.spans[0]] == [
        "decode.scan", "decode", "decode.engines"]
    assert [n for _lo, _hi, n in pt.spans[1]] == ["decode", "decode.verify"]
    # idle: 0-60 (scan 0-50, engines 50-60) and 90-100 (engines 90-95)
    # in request 0; 200-250 (verify 240-250), 310-400 (verify 310-320)
    assert pgt.idle_named(pt) == pytest.approx(100 * (60 + 5 + 10 + 10)
                                               / (70 + 140))
    empty = pgt.collect(_events(False), names)
    assert empty.spans == [[], []]
    assert pgt.idle_named(empty) is None


def test_a_program_without_trace_opens_nothing(monkeypatch, capsys):
    import lz4tpu_torch

    assert pgt.recording() is not None
    monkeypatch.delattr(lz4tpu_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "lz4tpu_torch.trace", None)
    assert pgt.recording() is None
    monkeypatch.setattr(harness, "program_environment", lambda: None)
    assert pgt.main(["--workload", "refbench-256m", "--seed", "1",
                     "--device", "cpu"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", ["refbench-256m",
                                      "encode-words32m-emit"])
def test_a_small_run_on_the_cpu(workload, monkeypatch, capsys):
    """The whole run at 16 KiB a request: every answer right, the costs
    read; the CPU has no profiler here, so no span reading."""
    monkeypatch.setattr(harness, "program_environment", lambda: None)
    monkeypatch.setattr(pgt, "span_cost", lambda: {"off.span": 0.0})
    assert pgt.main(["--workload", workload, "--seed", "3000000123",
                     "--device", "cpu", "--size", "16384",
                     "--turns", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["device"] == "cpu"
    assert set(out["program"]) == set(pgt.READINGS[
        harness.load_cell(workload).traffic["entry"]])
    assert len(out["on_cost"]["plain_ms"]) == len(
        out["on_cost"]["recorded_ms"]) == 2
