"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import os
import shutil

import pytest

from conftest import ROOT, small
from portbench import judge, spec

B = spec.bench(ROOT)
CELLS = [w["name"] for w in B["workloads"]]
METRICS = B["end_to_end"] + B["per_layer"]


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    assert B["command"] == ["python3", "portbench/run.py"]
    assert len(json.dumps(B)) < 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in B["configs"]])
def test_names_use_allowed_characters(name):
    assert spec.NAME.match(name), name


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entries(m):
    assert spec.UNIT.match(m["unit"]), m["unit"]
    assert m["better"] in ("lower", "higher")
    if m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        assert m["workloads"]
    for w in m.get("workloads", []):
        assert w in CELLS


def test_names_are_unique():
    for group in (METRICS, B["workloads"], B["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve_by_name(name):
    cell = spec.cell(B, name)
    wl = spec.workload(name)
    assert wl["config"] == cell["config"]
    assert wl["why"] == cell["why"] and len(cell["why"]) <= 200
    config = spec.load_module("configs", cell["config"])
    assert {"CONFIG", "SOURCE", "REDUCED", "ASSUMED", "build"} \
        <= set(vars(config))
    assert set(config.REDUCED) <= set(config.CONFIG)
    assert hasattr(spec.load_module("entries", wl["entry"]), "Driver")
    assert hasattr(spec.load_module("reference", cell["config"]),
                   "problem")
    assert set(wl["limits"]) == set(judge.NUMBERS)
    for m in spec.end_to_end(B, name) + spec.per_layer(B, name):
        assert hasattr(spec.load_module("metrics", m["name"]), "read")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_what_its_layer_metrics_move(name):
    e2e = {m["name"] for m in spec.end_to_end(B, name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(B, name)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (name, m["name"])


def test_config_files_and_sources():
    for c in B["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.py"
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["source"] == spec.load_module("configs", c["name"]).SOURCE
        assert c["reduced"] == spec.load_module("configs",
                                                c["name"]).REDUCED
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_adding_a_workload_file_makes_a_new_cell(tmp_path, monkeypatch):
    """A copy of the benchmark with one more workload file and its
    BENCHMARK.json entry runs the new cell, with no other edit."""
    from portbench import run
    tree = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), tree,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    wl = spec.workload(CELLS[0])
    wl["traffic"]["scale"] = 2e-3
    wl["why"] = "the cart-pole re-solved from twice the dispersion"
    (tree / "workloads" / "cartpole-lgl5.wide.json").write_text(
        json.dumps(wl))
    b = json.loads(json.dumps(B))
    b["workloads"].append(dict(name="cartpole-lgl5.wide",
                               config="cartpole-lgl5", traffic="wide",
                               chips=1, why=wl["why"]))
    for m in b["end_to_end"] + b["per_layer"]:
        if CELLS[0] in m.get("workloads", []):
            m["workloads"].append("cartpole-lgl5.wide")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(spec, "HERE", str(tree))
    overrides, lanes = small(CELLS[0])
    res, found = run.run_cell("cartpole-lgl5.wide", 5, 0.0, False,
                              device="cpu", overrides=overrides,
                              root=str(tmp_path))
    assert res["correct"] and not found
    assert {m["name"] for m in spec.end_to_end(B, CELLS[0])} \
        == set(res["metrics"])


def test_a_per_layer_metric_must_list_its_cells():
    b = json.loads(json.dumps(B))
    del b["per_layer"][0]["workloads"]
    with pytest.raises(ValueError):
        spec.per_layer(b, CELLS[0])
