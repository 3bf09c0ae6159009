"""The per-layer metrics that read the fused loop's stage counters: the
median of a unit's counter over its iterations, silent on a program
without the counters, and reported by a traced run of every cell they
list."""

import pytest

from conftest import ROOT, small
from portbench import run, spec
from portbench.stages import per_iter

B = spec.bench(ROOT)
STAGE_METRICS = [m for m in B["per_layer"]
                 if m["name"].endswith(("ms_per_iter.solve",
                                        "ms_per_iter.ensemble",
                                        "launches_per_iter.solve"))]
# the cells that some stage metric lists
CELLS = [w["name"] for w in B["workloads"]
         if any(w["name"] in m["workloads"] for m in STAGE_METRICS)]


class FakeRun:
    def __init__(self, stats):
        self.stats = stats


def test_per_iter_is_the_median_over_units():
    r = FakeRun([dict(iterations=10, ad_s=1.0), dict(iterations=10,
                                                     ad_s=9.0),
                 dict(iterations=5, ad_s=1.0)])
    assert per_iter(r, "ad_s", 1e3) == pytest.approx(200.0)


def test_per_iter_is_silent_without_the_counter():
    """The parent's stats hold iterations and syncs only."""
    r = FakeRun([dict(iterations=14, syncs=40, factorizations=28)])
    assert per_iter(r, "ad_s", 1e3) is None
    assert per_iter(FakeRun([]), "k1_launches") is None


@pytest.mark.parametrize("m", STAGE_METRICS, ids=lambda m: m["name"])
def test_reader_reads_its_counter(m):
    key = {"ad": "ad_s", "kkt": "kkt_s", "ls": "ls_s", "read": "read_s",
           "k1": "k1_launches"}[m["name"].split(".")[1].split("_")[0]]
    scale = 1.0 if key == "k1_launches" else 1e3
    r = FakeRun([dict(iterations=4, **{key: 2.0})])
    assert spec.load_module("metrics", m["name"]).read(r) == \
        pytest.approx(0.5 * scale)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_stage_metrics(name, monkeypatch):
    plain = spec.workload
    monkeypatch.setattr(spec, "workload", lambda n: dict(
        plain(n), trace={"from": 1, "units": 1}))
    overrides, lanes = small(name)
    res, _ = run.run_cell(name, 2 ** 31 + 11, 0.0, True, device="cpu",
                          overrides=overrides, lanes=lanes)
    mine = {m["name"] for m in STAGE_METRICS if name in m["workloads"]}
    assert mine <= set(res["metrics"])
    for n in mine:
        assert res["metrics"][n]["value"] >= 0
