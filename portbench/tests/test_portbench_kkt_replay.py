"""The per-layer metrics that read the block KKT's graph counters: the
median share of replayed iterations over a window's units, silent on a
program without the counters, and reported by a traced run of their
cells."""

import pytest

from conftest import ROOT, small
from portbench import run, spec
from portbench.kkt_replay import replay_share

B = spec.bench(ROOT)
SHARES = [m for m in B["per_layer"]
          if m["name"].startswith("fused.kkt_replay_share.")]


class FakeRun:
    def __init__(self, stats):
        self.stats = stats


def test_share_is_the_median_over_units():
    r = FakeRun([dict(kkt_replays=14, kkt_eager=0),
                 dict(kkt_replays=0, kkt_eager=14),
                 dict(kkt_replays=12, kkt_eager=3),
                 dict(iterations=4)])
    assert replay_share(r) == pytest.approx(0.8)


def test_share_is_silent_without_the_counters():
    """The parent's stats hold no KKT counters, only the AD's."""
    assert replay_share(FakeRun([dict(iterations=14, ad_replays=15,
                                      ad_eager=0)])) is None
    assert replay_share(FakeRun([])) is None


@pytest.mark.parametrize("m", SHARES, ids=lambda m: m["name"])
def test_share_entries(m):
    """Metrics of the block KKT layer, each moving the end-to-end metric
    of every cell it lists."""
    assert (m["unit"], m["better"], m["source"], m["layer"]) == \
        ("share", "higher", "program_counter", "block KKT")
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in spec.end_to_end(B, cell)}
    reader = spec.load_module("metrics", m["name"])
    assert reader.read(FakeRun([dict(kkt_replays=3, kkt_eager=1)])) == 0.75


@pytest.mark.parametrize("m,cell", [
    pytest.param(m, c, id=f"{m['name']}-{spec.cell(B, c)['traffic']}")
    for m in SHARES for c in m["workloads"]])
def test_traced_run_reports_the_share(m, cell, monkeypatch):
    """On the CPU every iteration's KKT is eager, so the share reads 0 in
    a traced run of each cell the metric lists."""
    plain = spec.workload
    monkeypatch.setattr(spec, "workload", lambda n: dict(
        plain(n), trace={"from": 1, "units": 1}))
    overrides, lanes = small(cell)
    res, _ = run.run_cell(cell, 2 ** 31 + 31, 0.0, True, device="cpu",
                          overrides=overrides, lanes=lanes)
    assert res["metrics"][m["name"]] == {"value": 0.0, "unit": "share"}
