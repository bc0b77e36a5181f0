"""lz4bench's cells are data: each is found by its name, and a cell added
as files alone runs.  CPU only, at small sizes."""

import json
import pathlib
import shutil
import time

import pytest

from lz4bench import harness, tracing

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = 64 << 10


def test_every_cell_is_found_by_name():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        assert harness.entry_class(cell.traffic["entry"])
        for spec in cell.traffic["requests"]:
            assert callable(harness.corpus(spec["corpus"]).make)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(m["name"]).read)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for name in m["workloads"]:
            cell = harness.load_cell(name)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_every_span_names_a_function_of_the_program():
    import importlib

    for name, spec in tracing.span_files().items():
        mod = importlib.import_module(spec["module"])
        assert callable(getattr(mod, spec["attr"])), name


def test_unknown_workload_is_refused():
    with pytest.raises(harness.BenchError):
        harness.load_cell("no-such-cell")


def _added_cell(tmp_path, name, traffic, config, frame=None):
    """A cell that exists only as files and entries: ``traffic`` (a file
    under lz4bench/traffic/, copied, or a dict) under ``config``'s file
    with ``frame`` flags changed, reporting decode_gbps and the decode
    cell's per-layer metrics."""
    conf = json.loads((ROOT / f"lz4bench/configs/{config}.json")
                      .read_text())
    conf.update(name=f"{config}-added", frame=dict(conf["frame"],
                                                   **(frame or {})))
    (tmp_path / "config.json").write_text(json.dumps(conf))
    if isinstance(traffic, str):
        traffic = json.loads((ROOT / f"lz4bench/traffic/{traffic}.json")
                             .read_text())
    (tmp_path / f"{name}.json").write_text(json.dumps(traffic))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": conf["name"], "source": "test",
                             "file": str(tmp_path / "config.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": conf["name"],
                               "traffic": name, "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("moves", m["name"]) == "decode_gbps":
            m["workloads"].append(name)
    return harness.load_cell(name, bench, root=ROOT, traffic_dir=tmp_path)


FRAG = {"entry": "decode", "clients": 1, "loop": "closed",
        "requests": [{"corpus": "frag", "bytes": 1 << 25, "stream": 0}],
        "traced_requests": 2, "why": "added in a test"}


@pytest.mark.parametrize("name,traffic,config,frame", [
    ("frag-bsum", FRAG, "lz4f-linked", {"block_checksum": True}),
    ("words32m-linked", "words32m", "lz4f-linked", None),
    ("words32m-cli", "words32m", "lz4cli-default", None)])
def test_a_cell_added_as_files_runs(tmp_path, name, traffic, config, frame):
    cell = _added_cell(tmp_path, name, traffic, config, frame)
    assert [m["name"] for m in cell.end_to_end] == ["decode_gbps", "setup_s"]
    out = harness.run(cell, 2**31 + 5, 0.3, False, "cpu",
                      time.perf_counter(), size=SMALL)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"decode_gbps", "setup_s"}
    assert list(out)[-1] == "checks"
    traced = harness.run(cell, 2**31 + 5, 0.3, True, "cpu",
                         time.perf_counter(), size=SMALL)
    assert traced["correct"] and traced["attempted"] == \
        cell.traffic["traced_requests"]
    # the device's readings need the card; the host's are read here
    assert {"stage_ms.decode", "verify_ms.decode", "host_cpu_ms.decode"} \
        >= set(traced["metrics"]) >= {"verify_ms.decode",
                                      "host_cpu_ms.decode"}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_runs_small_on_the_cpu(workload):
    cell = harness.load_cell(workload)
    out = harness.run(cell, 7, 0.2, False, "cpu", time.perf_counter(),
                      size=SMALL)
    assert out["correct"], out["checks"]
    assert {m["name"] for m in cell.end_to_end} == set(out["metrics"])


def test_a_metric_added_as_a_file_is_read(tmp_path, monkeypatch):
    metrics = tmp_path / "metrics"
    shutil.copytree(harness.HERE / "metrics", metrics)
    (metrics / "requests_done.py").write_text(
        "def read(window):\n    return len(window.lat)\n")
    monkeypatch.setattr(harness, "reader", lambda name: harness._load_file(
        metrics / f"{name}.py", "metric reader"))
    cell = harness.load_cell("refbench-256m")
    cell.end_to_end.append({"name": "requests_done", "unit": "requests"})
    win = harness.Window(seconds=1.0, setup_s=2.0, lat=[0.5, 0.5],
                         raw=[10, 20])
    got = harness.read_end_to_end(cell, win)
    assert got["requests_done"] == {"value": 2, "unit": "requests"}
    assert got["setup_s"]["value"] == 2.0
    assert got["decode_gbps"]["value"] == pytest.approx(30 / 1.0 / 1e9)
