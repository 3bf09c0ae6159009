"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
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


@pytest.mark.parametrize("name", CELLS)
def test_driver_keeps_the_contract(name):
    """The cell's entry at its CPU test size exposes what `spec.py` names,
    and its configuration's TEST_OVERRIDES change keys of its CONFIG."""
    from portbench import run
    cell = spec.cell(B, name)
    config = spec.load_module("configs", cell["config"])
    assert config.TEST_OVERRIDES and \
        set(config.TEST_OVERRIDES) <= set(config.CONFIG)
    entry = spec.load_module("entries", spec.workload(name)["entry"])
    assert entry.TEST_LANES is None or entry.TEST_LANES >= 1
    d = run.Cell(name, "cpu", *small(name)).driver
    assert isinstance(d.unit_name, str) and callable(d.unit)
    assert isinstance(d.sigma, float)
    assert d.optimizer.nlp is d.nlp
    assert np.asarray(d.base).shape == (d.nlp.numPrimal,)


# a configuration, its reference, an entry and a cell that join a copy of
# the benchmark by new files alone: the cart-pole under another name, run
# by an entry that holds its problem as `problem` and has no `phase`
TWIN = "cartpole_twin"
TWIN_CELL = TWIN + ".solve"
TWIN_ENTRY = '''"""A solve entry that holds its problem as `problem`."""

import numpy as np

TEST_LANES = None


class Driver:
    unit_name = "portbench.twin"

    def __init__(self, ast, config, cfg, traffic):
        self.problem = config.build(ast, cfg)
        self.optimizer = self.problem.optimizer
        self.optimizer.set_PrintLevel(3)
        self.nlp = self.optimizer.nlp
        self.base = self.problem.makeSolverInput()
        self.sigma = float(self.optimizer.ObjScale)
        self.ast = ast

    def unit(self, starts):
        self.problem.collectSolverOutput(starts[0])
        flag = self.problem.optimize()
        opt = self.optimizer
        return dict(x=self.problem.makeSolverInput()[None],
                    lamE=np.asarray(opt.LastEqLmults)[None],
                    lamI=np.asarray(opt.LastIqLmults)[None],
                    obj=np.array([opt.LastObjVal]),
                    flag=np.array([int(flag)]),
                    iters=np.array([opt.LastIterNum]),
                    stats=dict(opt.LastFusedStats or {}))

    def probe(self):
        opt, cfg = self.optimizer, self.ast.config
        state = [cfg.tensor(a, self.nlp.device) for a in (
            self.problem.makeSolverInput(), opt.LastSlacks,
            opt.LastEqLmults, opt.LastIqLmults)]
        return dict(opt.measure_stage_times(*state, opt.initMu,
                                            opt.ObjScale))
'''


def _files(tree):
    """{relative path: bytes} of the benchmark's files under `tree`."""
    out = {}
    for d, dirs, names in os.walk(tree):
        dirs[:] = [x for x in dirs if x not in (".cache", "__pycache__")]
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, tree)] = f.read()
    return out


def test_adding_a_configuration_by_files_alone(tmp_path):
    """A copy of the benchmark with one more configuration, reference,
    entry and workload file, and their BENCHMARK.json entries: the copy's
    own tests of the new names pass, and no file of the benchmark was
    edited."""
    src = os.path.join(ROOT, "portbench")
    tree = tmp_path / "portbench"
    shutil.copytree(src, tree,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    os.symlink(os.path.join(ROOT, "asset_asrl_torch"),
               tmp_path / "asset_asrl_torch")
    base = next(c for c in CELLS if spec.workload(c)["entry"] == "solve")
    cfg_name = spec.cell(B, base)["config"]
    # overrides of its own: the original's mesh (the inflated-multiplier
    # fault shows in `compl` only at some meshes) and a wider cart bound
    text = (tree / "configs" / f"{cfg_name}.py").read_text()
    (tree / "configs" / f"{TWIN}.py").write_text(
        text + "\nTEST_OVERRIDES = dict(TEST_OVERRIDES, x_max=2.5)\n")
    shutil.copy(tree / "reference" / f"{cfg_name}.py",
                tree / "reference" / f"{TWIN}.py")
    (tree / "entries" / "twin.py").write_text(TWIN_ENTRY)
    wl = dict(spec.workload(base), config=TWIN, entry="twin",
              why="the cart-pole under another name, re-solved by an "
                  "entry with no phase")
    (tree / "workloads" / f"{TWIN_CELL}.json").write_text(json.dumps(wl))
    b = json.loads(json.dumps(B))
    c = next(c for c in b["configs"] if c["name"] == cfg_name)
    b["configs"].append(dict(c, name=TWIN,
                             file=f"portbench/configs/{TWIN}.py"))
    b["workloads"].append(dict(name=TWIN_CELL, config=TWIN, traffic="solve",
                               chips=1, why=wl["why"]))
    for m in b["end_to_end"] + b["per_layer"]:
        if base in m.get("workloads", []):
            m["workloads"].append(TWIN_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b, indent=1))

    out = subprocess.run(
        [sys.executable, "-m", "pytest", str(tree / "tests"), "-v",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-k", TWIN],
        cwd=tmp_path, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = {ln.split("::")[0].split("/")[-1]
              for ln in out.stdout.splitlines() if " PASSED" in ln}
    assert passed == {"test_portbench_reference.py", "test_portbench_run.py",
                      "test_portbench_spec.py",
                      "test_portbench_stages.py"}, out.stdout[-4000:]
    copied = _files(tree)
    for rel, data in _files(src).items():
        assert copied[rel] == data, rel
