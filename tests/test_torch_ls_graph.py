"""The fused loop's line search replayed from a CUDA graph
(`kkt_block._Graphed`): eager on the CPU, one graph per key (what the search
computes with and its inputs' shapes) shared by the passes and solves of
one BlockKKT, a failed capture eager from then on, the counters in
`PSIOPT.LastFusedStats`, and, on a card, solves bitwise equal to the
eager line search."""

import numpy as np
import pytest
import torch

import asset_asrl_torch as tast
from asset_asrl_torch.Solvers import fused
from chip_smoke import build_brachistochrone, build_cartpole

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


class FakeGraph:
    """A stand-in for a captured line search: the eager search, counted."""
    made = []

    def __init__(self, fn, inputs, pool):
        self.fn, self.calls = fn, 0
        FakeGraph.made.append(self)

    def __call__(self, *inputs):
        self.calls += 1
        return self.fn(*inputs)


def solved(phase, fake=None, schedule="optimize"):
    """(flag, iterations, objective, answer, stats) of one fused solve,
    with a line search in every pass; with `fake`, the BlockKKT captures
    its line searches by `fake`."""
    phase.optimizer.set_PrintLevel(3)
    phase.optimizer.set_SoeLSMode("L1")
    phase.transcribe()
    if fake is not None:
        phase.optimizer.kkt._ls_graphs = {}
    flag = getattr(phase, schedule)()
    opt = phase.optimizer
    return (flag, opt.LastIterNum, opt.LastObjVal,
            np.asarray(phase.makeSolverInput()), dict(opt.LastFusedStats))


def test_cpu_line_searches_run_eagerly():
    """A CPU BlockKKT keeps no graphs: every line search is eager and
    counted."""
    p = build_brachistochrone(tast, "LGL3", 8)
    flag, iters, _, _, st = solved(p)
    assert flag == 0 and p.optimizer.kkt._ls_graphs is None
    assert (st["ls_replays"], st["ls_eager"]) == (0, iters)


@pytest.mark.parametrize("schedule,keys", [("optimize", 1),
                                           ("solve_optimize", 2)])
def test_one_graph_per_key_shared_by_passes_and_solves(monkeypatch,
                                                       schedule, keys):
    """With a capture step every line search replays and the solve is
    the same; an SOE pass (sigma 0) and an OPT pass are two keys; a second
    solve from the same BlockKKT captures nothing new."""
    monkeypatch.setattr(fused, "_Graphed", FakeGraph)
    FakeGraph.made = []
    plain = solved(build_brachistochrone(tast, "LGL3", 8),
                   schedule=schedule)
    p = build_brachistochrone(tast, "LGL3", 8)
    got = solved(p, FakeGraph, schedule)
    assert got[:3] == plain[:3] and np.array_equal(got[3], plain[3])
    st = got[4]
    assert (st["ls_replays"], st["ls_eager"]) == (got[1], 0)
    assert len(FakeGraph.made) == len(p.optimizer.kkt._ls_graphs) == keys
    again = getattr(p, schedule)()
    assert again == 0 and len(FakeGraph.made) == keys
    assert sum(g.calls for g in FakeGraph.made) == \
        got[1] + p.optimizer.LastIterNum


def test_failed_capture_stays_eager(monkeypatch):
    """A capture that raises a RuntimeError is tried once a key; that key
    runs eagerly from then on and the solve is unchanged."""
    tries = []

    def capture(fn, inputs, pool):
        tries.append(1)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(fused, "_Graphed", capture)
    plain = solved(build_brachistochrone(tast, "LGL3", 8))
    got = solved(build_brachistochrone(tast, "LGL3", 8), capture)
    assert got[:3] == plain[:3] and np.array_equal(got[3], plain[3])
    assert tries == [1]
    assert (got[4]["ls_replays"], got[4]["ls_eager"]) == (0, got[1])


def test_capture_errors_other_than_runtime_propagate(monkeypatch):
    def capture(*a):
        raise ValueError("not a capture failure")
    monkeypatch.setattr(fused, "_Graphed", capture)
    with pytest.raises(ValueError):
        solved(build_brachistochrone(tast, "LGL3", 8), capture)


# ------------------------------------------------------------------ card
@pytest.fixture
def on_card():
    """Problems built inside the test live on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    asset_asrl_torch.config.use_device("cuda")
    try:
        yield
    finally:
        asset_asrl_torch.config.use_device("cpu")


def _delta3():
    from asset_asrl_torch.examples.Delta3Launch import build_ocp
    return build_ocp(8)


@pytest.mark.cuda
@pytest.mark.parametrize("problem,schedule", [
    ("cartpole", "optimize"), ("delta3", "solve_optimize")])
def test_fused_solve_with_graphs_is_the_eager_solve(on_card, problem,
                                                    schedule):
    """The 40-segment CartPole and Delta III at 8 segments a phase (two
    passes, links) solved with the line search replayed and eager: the
    same flag, iterations, objective and answer, bitwise."""
    out = []
    for eager in (False, True):
        p = build_cartpole(tast, 40) if problem == "cartpole" else _delta3()
        p.optimizer.set_PrintLevel(3)
        p.transcribe()
        if eager:
            p.optimizer.kkt._ls_graphs = None
        flag = getattr(p, schedule)()
        opt = p.optimizer
        st = opt.LastFusedStats
        out.append((flag, opt.LastIterNum, opt.LastObjVal,
                    np.asarray(p.makeSolverInput())))
        if eager:
            assert st["ls_replays"] == 0 and st["ls_eager"] > 0
        else:
            assert st["ls_eager"] == 0
            assert st["ls_replays"] == st["iterations"]
    (f1, n1, o1, x1), (f2, n2, o2, x2) = out
    assert (f1, n1, o1) == (f2, n2, o2)
    assert f1 == 0
    assert np.array_equal(x1, x2)
