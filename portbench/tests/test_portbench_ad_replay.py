"""The per-layer metrics that read the family AD's graph counters: the
median share of replayed passes over a window's units, silent on a program
without the counters, and reported by a traced run of their cells."""

import pytest

from conftest import ROOT, small
from portbench import run, spec
from portbench.ad_replay import replay_share

B = spec.bench(ROOT)
SHARES = [m for m in B["per_layer"]
          if m["name"].startswith("fused.ad_replay_share.")]


class FakeRun:
    def __init__(self, stats):
        self.stats = stats


def test_share_is_the_median_over_units():
    r = FakeRun([dict(ad_replays=15, ad_eager=0),
                 dict(ad_replays=0, ad_eager=15),
                 dict(ad_replays=12, ad_eager=3),
                 dict(iterations=4)])
    assert replay_share(r) == pytest.approx(0.8)


def test_share_is_silent_without_the_counters():
    """The parent's stats hold no AD counters."""
    assert replay_share(FakeRun([dict(iterations=14, ad_s=2.0)])) is None
    assert replay_share(FakeRun([])) is None


@pytest.mark.parametrize("m", SHARES, ids=lambda m: m["name"])
def test_share_entries(m):
    """Metrics of the family AD layer, each moving the end-to-end metric
    of every cell it lists."""
    assert (m["unit"], m["better"], m["source"], m["layer"]) == \
        ("share", "higher", "program_counter", "family AD")
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in spec.end_to_end(B, cell)}
    reader = spec.load_module("metrics", m["name"])
    assert reader.read(FakeRun([dict(ad_replays=3, ad_eager=1)])) == 0.75


@pytest.mark.parametrize("m", SHARES, ids=lambda m: m["name"])
def test_traced_run_reports_the_share(m, monkeypatch):
    """On the CPU every pass is eager, so the share reads 0 in a traced
    run of each cell the metric lists."""
    plain = spec.workload
    monkeypatch.setattr(spec, "workload", lambda n: dict(
        plain(n), trace={"from": 1, "units": 1}))
    for name in m["workloads"]:
        overrides, lanes = small(name)
        res, _ = run.run_cell(name, 2 ** 31 + 29, 0.0, True, device="cpu",
                              overrides=overrides, lanes=lanes)
        assert res["metrics"][m["name"]] == {"value": 0.0, "unit": "share"}
