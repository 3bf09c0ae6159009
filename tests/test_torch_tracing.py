"""The port's own spans and stage counters: `Utils.span`, the fused loop's
`asset.*` profiler ranges and its per-stage host seconds in `fn.stats`
(`PSIOPT.LastFusedStats`), the collector's ranges, and K1's launch count
by shape."""

import contextlib
import gc
import json
import time

import numpy as np
import pytest
import torch

import asset_asrl_torch as tast
from asset_asrl_torch.Solvers.cuda_kernels import gj_inverse, \
    gj_inverse_inertia
from asset_asrl_torch.parallel import solve_ensemble
from chip_smoke import build_brachistochrone, build_cartpole

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

STAGES = ("ad_s", "kkt_s", "ls_s", "read_s", "loop_s", "k1_launches")
PROBLEMS = {
    "brachistochrone_LGL3_8": lambda: build_brachistochrone(tast, "LGL3", 8),
    "cartpole_LGL5_12": lambda: build_cartpole(tast, 12),
}
# every program span a fused solve of a problem with inequalities enters
SPANS = ["asset.fused.iteration", "asset.fused.family_ad",
         "asset.fused.assembly", "asset.fused.factor", "asset.fused.solve",
         "asset.fused.line_search", "asset.fused.read",
         "asset.kkt.bcr_factor", "asset.kkt.bcr_solve", "asset.k1",
         "asset.nlp.value_pass", "asset.ad.eq0.gather", "asset.ad.eq0.vj",
         "asset.ad.iq0.vj", "asset.ad.obj0.hess"]


def solved(name):
    p = PROBLEMS[name]()
    p.optimizer.set_PrintLevel(3)
    return p, p.optimize()


class RecordSpy:
    """Counts the `record_function` ranges entered, by name."""

    def __init__(self, monkeypatch):
        self.names = []
        plain = torch.profiler.record_function

        def spy(name, *a, **k):
            self.names.append(name)
            return plain(name, *a, **k)
        monkeypatch.setattr(torch.profiler, "record_function", spy)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_stage_counters_of_a_fused_solve(name):
    """Every stage key is there and >= 0; AD, KKT and the line search took
    time; the named stages do not overlap, so their sum is at most the
    run's seconds, which are at most the solve's; the solve's
    LastFuncTime / LastKKTTime are the pass's stages."""
    p, flag = solved(name)
    opt = p.optimizer
    assert flag == 0
    st = opt.LastFusedStats
    assert set(STAGES) <= set(st)
    assert all(st[k] >= 0 for k in STAGES)
    assert all(st[k] > 0 for k in ("ad_s", "kkt_s", "ls_s"))
    assert st["ad_s"] + st["kkt_s"] + st["ls_s"] + st["read_s"] \
        <= st["loop_s"] <= opt.LastTotalTime
    assert st["k1_launches"] == 0          # no K1 launch on the CPU
    assert opt.LastFuncTime == st["ad_s"] + st["ls_s"]
    assert opt.LastKKTTime == st["kkt_s"]


def test_stages_reset_at_each_run():
    """A second solve reports its own seconds, not the sum of both."""
    p, _ = solved("brachistochrone_LGL3_8")
    opt = p.optimizer
    first = dict(opt.LastFusedStats)
    assert first["loop_s"] <= opt.LastTotalTime
    p.optimize()
    second = opt.LastFusedStats
    assert second["loop_s"] <= opt.LastTotalTime
    assert second["iterations"] == opt.LastIterNum
    assert opt.LastFuncTime == second["ad_s"] + second["ls_s"]


@pytest.fixture(scope="module")
def traced_span_names(tmp_path_factory):
    """The names of every `asset.*` range in the Chrome trace that
    `Utils.Profiler` writes around a fused CartPole solve."""
    p = build_cartpole(tast, 12)
    p.optimizer.set_PrintLevel(3)
    with tast.Utils.Profiler(tmp_path_factory.mktemp("trace")) as prof:
        assert p.optimize() == 0
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events
            if str(e.get("name", "")).startswith("asset.")}


@pytest.mark.parametrize("span", SPANS)
def test_profiler_trace_names_the_stage(traced_span_names, span):
    assert span in traced_span_names


def test_profiler_trace_names_no_benchmark_span(traced_span_names):
    assert traced_span_names
    assert not any(n.startswith("portbench.") for n in traced_span_names)


@pytest.mark.parametrize("profiled", [False, True])
def test_record_function_only_under_a_profiler(monkeypatch, tmp_path,
                                               profiled):
    """With no profiler recording, no `record_function` range is entered;
    under one, the loop's ranges are."""
    p = build_brachistochrone(tast, "LGL3", 8)
    p.optimizer.set_PrintLevel(3)
    spy = RecordSpy(monkeypatch)
    if profiled:
        with tast.Utils.Profiler(tmp_path):
            p.optimize()
        assert "asset.fused.family_ad" in spy.names
    else:
        p.optimize()
        assert spy.names == []


@pytest.mark.parametrize("profiled", [False, True])
def test_span_adds_host_seconds_and_never_synchronizes(monkeypatch,
                                                       tmp_path, profiled):
    def sync(*a, **k):
        raise AssertionError("span synchronized the device")
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    acc = {"t": 1.0}
    spy = RecordSpy(monkeypatch)
    with tast.Utils.Profiler(tmp_path) if profiled else \
            contextlib.nullcontext():
        with tast.Utils.span("asset.test", acc, "t"):
            time.sleep(0.02)
        with tast.Utils.span("asset.test.untimed"):
            pass
    assert acc["t"] >= 1.02
    assert [n for n in spy.names if n.startswith("asset.")] == \
        (["asset.test", "asset.test.untimed"] if profiled else [])


@pytest.mark.parametrize("profiled", [False, True])
def test_gc_collection_is_a_range_under_a_profiler(monkeypatch, tmp_path,
                                                   profiled):
    """A collection made while a profiler records is `asset.gc.gen<g>` in
    its trace; with no profiler, the collector's hook opens no range."""
    opened = []
    plain = torch._C._profiler._RecordFunctionFast

    def spy(name, *a, **k):
        opened.append(name)
        return plain(name, *a, **k)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", spy)
    if not profiled:
        gc.collect()
        assert opened == []
        return
    with tast.Utils.Profiler(tmp_path) as prof:
        gc.collect()
    assert "asset.gc.gen2" in opened
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "asset.gc.gen2" in names


def test_ensemble_stats_carry_the_stage_keys():
    p = build_brachistochrone(tast, "LGL3", 8)
    p.optimizer.set_PrintLevel(3)
    rng = np.random.default_rng(5)
    n = len(p.makeSolverInput())
    res = solve_ensemble(p, perturb_states=[rng.normal(size=n) * 1e-4
                                            for _ in range(3)])
    assert (res["flags"] == 0).all()
    st = p.optimizer.LastFusedStats
    assert set(STAGES) <= set(st)
    assert all(st[k] > 0 for k in ("ad_s", "kkt_s", "ls_s", "loop_s"))
    assert st["ad_s"] + st["kkt_s"] + st["ls_s"] + st["read_s"] \
        <= st["loop_s"]


def test_cpu_inverse_counts_no_shape():
    before = dict(gj_inverse.shapes)
    gj_inverse_inertia(torch.eye(6, dtype=torch.float64).expand(4, 6, 6)
                       .contiguous())
    assert gj_inverse.shapes == before


@pytest.mark.cuda
def test_k1_shapes_count_launches_per_shape():
    """`gj_inverse.shapes` counts K1's launches by (K, W), narrow and
    wide; a fused solve's `k1_launches` is the launches it made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    before = dict(gj_inverse.shapes)
    for K, W in ((5, 24), (5, 24), (3, 85), (1, 24)):
        gj_inverse_inertia(torch.eye(W, dtype=torch.float64, device="cuda")
                           .expand(K, W, W).contiguous())
    torch.cuda.synchronize()
    grown = {k: v - before.get(k, 0) for k, v in gj_inverse.shapes.items()
             if v != before.get(k, 0)}
    assert grown == {(5, 24): 2, (3, 85): 1, (1, 24): 1}

    asset_asrl_torch.config.use_device("cuda")
    try:
        p = build_brachistochrone(tast, "LGL3", 8)
        p.optimizer.set_PrintLevel(3)
        n0 = sum(gj_inverse.shapes.values())
        assert p.optimize() == 0
        st = p.optimizer.LastFusedStats
        assert st["k1_launches"] == sum(gj_inverse.shapes.values()) - n0 > 0
        assert p.optimizer.LastFuncTime > 0 and p.optimizer.LastKKTTime > 0
    finally:
        asset_asrl_torch.config.use_device("cpu")
