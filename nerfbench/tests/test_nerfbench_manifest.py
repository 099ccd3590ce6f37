"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix, driver and metric reader found by its name."""

import json
import os
import re

import pytest

from nerfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "nerfbench/run.py"]
    assert BENCH["paths"] == ["nerfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[g]]
    assert len(names) == len(set(names))
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    wl = harness.load_workload(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == entry["traffic"]
    assert os.path.isfile(os.path.join(harness.HERE, "drivers", f"{wl['kind']}.py"))
    harness.load_module("drivers", f"{wl['kind']}.py")
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    layer = harness.cell_metrics(BENCH, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    assert all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_run_configuration(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"nerfbench/configs/{config}.json"
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["cfg"]["nerf"]["model"]["table_dtype"] == "bfloat16"
    assert any(w["config"] == config for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module("metrics", f"{metric}.py")
    assert callable(mod.read) and mod.read(None) is None
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert set(m["workloads"]) <= set(CELLS)


def test_a_later_cell_is_files_alone(tmp_path, monkeypatch):
    """A new cell needs a workload file (and a traffic file) and no code."""
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    (tmp_path / "workloads").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "t.json").write_text(json.dumps({"kind": "train", "x": 1}))
    (tmp_path / "workloads" / "c.json").write_text(
        json.dumps({"config": "flagship", "traffic": "t", "x": 2}))
    assert harness.load_workload("c") == {"kind": "train", "x": 2, "config": "flagship",
                                          "traffic": "t"}
