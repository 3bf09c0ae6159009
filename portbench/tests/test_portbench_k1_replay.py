"""The per-layer metrics `k1_roofline.<cell>`: K1's bound over every
launch of the host-traced units (the host's `_inv_sym` calls and the
launches replayed from CUDA graphs) over K1's traced device time, silent
on a program that counts no replayed launch."""

import pytest

from conftest import ROOT
from portbench import spec
from portbench.k1_replay import k1_roofline
from portbench.roofline import k1_bound

B = spec.bench(ROOT)
ROOFS = [m for m in B["per_layer"] if m["name"].startswith("k1_roofline.")]
CELL = "cartpole-lgl5.solve-10k"


def replayed(launches):
    """A unit's stats: K1's replayed launches by (K, W), as the fused
    loop keeps them."""
    st = dict(k1_replayed=sum(launches.values()))
    st.update({f"k1_replayed.{K}x{W}": n for (K, W), n in launches.items()})
    return st


class FakeRun:
    def __init__(self, stats, traced):
        self.stats, self.traced = stats, traced


def traced(k1_s, k1_bound_s):
    return dict(k1_s=k1_s, k1_bound_s=k1_bound_s)


def test_bound_adds_the_host_traced_units_replays(monkeypatch):
    """Units [from + units, from + 2 units) are the host-traced ones: only
    their replayed launches join the bound of the host's calls."""
    monkeypatch.setattr(spec, "workload", lambda n: dict(
        trace={"from": 1, "units": 2}))
    stats = [replayed({(9, 9): 1000})] * 3 + [
        replayed({(164, 25): 10}),
        replayed({(164, 25): 5, (1, 28): 2})] + [
        replayed({(9, 9): 1000})]
    bound = 15 * k1_bound(164, 25)[0] + 2 * k1_bound(1, 28)[0] + 1e-6
    got = k1_roofline(FakeRun(stats, traced(2e-3, 1e-6)), CELL)
    assert got == pytest.approx(100.0 * bound / 2e-3)


def test_bound_without_host_calls(monkeypatch):
    monkeypatch.setattr(spec, "workload", lambda n: dict(
        trace={"from": 0, "units": 1}))
    stats = [{}, replayed({(40, 12): 3})]
    got = k1_roofline(FakeRun(stats, traced(1e-4, None)), CELL)
    assert got == pytest.approx(100.0 * 3 * k1_bound(40, 12)[0] / 1e-4)


def test_silent_without_the_counter_or_the_time(monkeypatch):
    """The parent's stats hold no `k1_replayed`; a CPU run traces no K1
    device time; an untraced run has no trace."""
    monkeypatch.setattr(spec, "workload", lambda n: dict(
        trace={"from": 0, "units": 1}))
    assert k1_roofline(FakeRun([{}, dict(k1_launches=9)],
                               traced(1e-3, 1e-5)), CELL) is None
    assert k1_roofline(FakeRun([{}, replayed({(4, 4): 1})],
                               traced(0.0, 1e-5)), CELL) is None
    assert k1_roofline(FakeRun([{}, replayed({})], None),
                       CELL) is None
    assert k1_roofline(FakeRun([{}], traced(1e-3, 1e-5)), CELL) is None


@pytest.mark.parametrize("m", ROOFS, ids=lambda m: m["name"])
def test_roofline_entries(m):
    """One metric a cell, of the K1 layer, named after the cell it reads
    and moving that cell's end-to-end metric; its reader reads that
    cell's host-traced units."""
    (cell,) = m["workloads"]
    assert m["name"] == "k1_roofline." + cell
    assert (m["unit"], m["better"], m["source"], m["layer"]) == \
        ("%", "higher", "device_trace", "kernel K1")
    assert m["moves"] in {e["name"] for e in spec.end_to_end(B, cell)}
    trace = spec.workload(cell)["trace"]
    mid = int(trace["from"]) + int(trace["units"])
    stats = [replayed({})] * (mid + 2 * int(trace["units"]))
    for i in range(mid, mid + int(trace["units"])):
        stats[i] = replayed({(100, 20): 7})
    reader = spec.load_module("metrics", m["name"])
    got = reader.read(FakeRun(stats, traced(1e-3, 0.0)))
    assert got == pytest.approx(
        100.0 * 7 * int(trace["units"]) * k1_bound(100, 20)[0] / 1e-3)
