"""The port's default solve is the JAX package's default solve: the fused
PSIOPT loop (`Solvers/fused.py`) with the least-squares multiplier start,
against the JAX package's fused loop on the CPU (reference calls jitted by
the JAX package itself), on single-phase problems and a two-phase
OptimalControlProblem with a link.  Also `PSIOPT.init`, InitLmults, ReturnBest, the
callbacks, stage timing and `storespmat`."""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from chip_smoke import build_brachistochrone, build_cartpole, build_formation
from test_torch_parallel import double_integrator

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

CASES = {
    "brachistochrone_LGL3_24": lambda ast: build_brachistochrone(
        ast, "LGL3", 24),
    "brachistochrone_Trapezoidal_24": lambda ast: build_brachistochrone(
        ast, "Trapezoidal", 24),
    "double_integrator_LGL3_12": lambda ast: double_integrator(ast, 12),
    "cartpole_LGL5_40": lambda ast: build_cartpole(ast, 40),
}


def close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(
        1.0, np.abs(b).max(initial=0.0))


@pytest.fixture(scope="module", params=sorted(CASES))
def default_pair(request):
    """One problem solved by both packages with default settings (the
    fused loop), keeping each pass's infos and the final KKT blocks."""
    out = []
    for ast in (jast, tast):
        p = CASES[request.param](ast)
        opt = p.optimizer
        opt.set_PrintLevel(2)
        opt.storespmat = True
        passes = []
        opt.LateCallBack = passes.append
        out.append((p, p.optimize(), passes))
    return out


def test_default_brachistochrone_is_the_jax_default():
    """The JAX package's default on the Brachistochrone (LGL3, 24
    segments): flag 0 in 8 iterations at 1.8012955182586587 (the host loop
    takes 12)."""
    p = build_brachistochrone(tast, "LGL3", 24)
    p.optimizer.set_PrintLevel(2)
    assert p.optimizer.UseFused and p.optimizer.InitLmults
    assert p.optimize() == 0
    assert p.optimizer.LastIterNum == 8
    assert abs(p.optimizer.LastObjVal - 1.8012955182586587) \
        <= 1e-9 * 1.8012955182586587


def test_default_solve_matches_jax_default(default_pair):
    (pj, fj, _), (pt, ft, _) = default_pair
    assert ft == fj == 0
    assert pt.optimizer.LastIterNum == pj.optimizer.LastIterNum
    assert abs(pt.optimizer.LastObjVal - pj.optimizer.LastObjVal) \
        <= 1e-9 * abs(pj.optimizer.LastObjVal)
    close(pt.makeSolverInput(), pj.makeSolverInput(), 1e-8)


def test_default_ocp_matches_jax_default():
    """A two-phase OptimalControlProblem under the default (fused) solve:
    formation flying at 80 segments a phase, linked at every node
    (PathToPath), with a border of 85 (the wide K1 path).  Flag and
    iterations exact, objective to 1e-9, x to 1e-8, one LateCallBack a
    pass with the iterate record's objective column to 1e-8.  The link
    rows at the end nodes repeat the boundary values, so the equality
    multipliers are not unique and the infeasibility columns after the
    first step (1e-7 apart here) are not compared."""
    out = []
    for ast in (jast, tast):
        ocp = build_formation(ast, 80)[0]
        opt = ocp.optimizer
        opt.set_PrintLevel(2)
        assert opt.UseFused and opt.InitLmults
        passes = []
        opt.LateCallBack = passes.append
        out.append((ocp.optimize(), opt.LastIterNum, opt.LastObjVal,
                    ocp._make_input(), passes, opt.kkt.bs.b))
    (fj, ij, oj, xj, pj, bj), (ft, it, ot, xt, pt, bt) = out
    assert ft == fj == 0 and it == ij and bt == bj == 85
    assert abs(ot - oj) <= 1e-9 * abs(oj)
    close(xt, xj, 1e-8)
    assert len(pj) == len(pt) == 1
    close(pt[0]["infos"][:, 0], pj[0]["infos"][:, 0], 1e-8)


def test_infos_match_jax(default_pair):
    """One LateCallBack a pass, and its iterate record: obj, kkt and econ
    of every iteration to 1e-8."""
    (_, _, passes_j), (pt, _, passes_t) = default_pair
    assert len(passes_j) == len(passes_t) == 1
    ij, it = passes_j[0]["infos"], passes_t[0]["infos"]
    assert it.shape == ij.shape == (pt.optimizer.LastIterNum, 9)
    for col in range(3):
        close(it[:, col], ij[:, col], 1e-8)
    assert np.array_equal(it[:, 7], ij[:, 7])      # ladder refactors


def test_storespmat_blocks_match_jax(default_pair):
    """The KKT blocks (diag, lower, B, C) at the final iterate."""
    (pj, _, _), (pt, _, _) = default_pair
    bj, bt = pj.optimizer.LastKKTBlocks, pt.optimizer.LastKKTBlocks
    assert len(bj) == len(bt) == 4
    for a, b in zip(bt, bj):
        close(a, b, 1e-12)


def delta_time_phase(ast):
    """`tests/test_parity.py::test_psiopt_init_pass`: a time objective, so
    the least-squares multipliers are non-zero at the guess."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class DI(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    ts = np.linspace(0, 2, 30)
    IG = [[t / 2, 0.5, t, 0.0] for t in ts]
    phase = DI().phase("LGL3", IG, 16)
    phase.addBoundaryValue("Front", [0, 1, 2], [0, 0, 0])
    phase.addBoundaryValue("Back", [0, 1], [1, 0])
    phase.addLUVarBound("Path", 3, -4.0, 4.0)
    phase.addDeltaTimeObjective(1.0)
    phase.optimizer.set_PrintLevel(2)
    return phase


def test_init_pass_matches_jax():
    """PSIOPT.init: slacks, multipliers and the least-squares equality
    multipliers to 1e-10; the warm-started optimize that follows gives
    the JAX package's flag, iterations and objective."""
    out = []
    for ast in (jast, tast):
        p = delta_time_phase(ast)
        p.transcribe()
        state = p.optimizer.init(p.makeSolverInput())
        p.optimizer.WarmStart = True
        flag = p.optimize()
        out.append((state, flag, p.optimizer.LastIterNum,
                    p.optimizer.LastObjVal))
    (sj, fj, ij, oj), (st, ft, it, ot) = out
    assert np.abs(st[2]).max() > 0.0
    for a, b in zip(st, sj):
        close(a, b, 1e-10)
    assert (ft, it) == (fj, ij) and ft == 0
    assert abs(ot - oj) <= 1e-9 * abs(oj)


def test_dense_init_pass_matches_jax():
    """PSIOPT.init on the dense backend."""
    out = []
    for ast in (jast, tast):
        p = delta_time_phase(ast)
        p.setKKTBackend("dense")
        p.transcribe()
        out.append(p.optimizer.init(p.makeSolverInput()))
    assert np.abs(out[1][2]).max() > 0.0
    for a, b in zip(*out):
        close(b, a, 1e-10)


def test_without_initlmults_fused_takes_host_loop_iterates():
    """InitLmults = False starts the equality multipliers at 0, as the
    host loop does; the fused loop then follows the host loop's iterates
    (the Brachistochrone's ladder never climbs twice)."""
    res = []
    for fused in (True, False):
        p = build_brachistochrone(tast, "LGL3", 24)
        p.optimizer.set_PrintLevel(2)
        p.optimizer.InitLmults = False
        p.optimizer.UseFused = fused
        res.append((p.optimize(), p.optimizer.LastIterNum,
                    p.makeSolverInput()))
    (f1, i1, x1), (f2, i2, x2) = res
    assert (f1, i1) == (f2, i2) == (0, 12)
    close(x1, x2, 1e-10)


def test_return_best_under_iteration_cap():
    """ReturnBest on a pass capped by MaxIters: NOTCONVERGED, and the
    iterate returned is the JAX package's best one (ECons), not the last
    step."""
    xs = []
    for ast, best in ((jast, True), (tast, True), (tast, False)):
        p = build_brachistochrone(ast, "LGL3", 24)
        p.optimizer.set_PrintLevel(2)
        p.optimizer.MaxIters = 4
        p.optimizer.ReturnBest = best
        assert p.optimize() == 2
        assert p.optimizer.LastIterNum == 4
        xs.append(p.makeSolverInput())
    close(xs[1], xs[0], 1e-8)
    assert np.abs(xs[2] - xs[1]).max() > 1e-6


def test_callbacks_timing_and_table(capsys):
    """LateCallBack once per fused pass (solve_optimize: SOE then OPT),
    EarlyCallBack once per host-loop iteration; the fused loop times its
    stages in the loop and LastFuncTime / LastKKTTime are their totals;
    PrintLevel 0 prints the iterate table."""
    p = build_brachistochrone(tast, "LGL3", 8)
    opt = p.optimizer
    opt.set_PrintLevel(2)
    late, early, passes = [], [], []

    def on_pass(d):
        late.append(d)
        passes.append(dict(opt.LastFusedStats))
    opt.LateCallBack, opt.EarlyCallBack = on_pass, early.append
    assert p.solve_optimize() == 0
    assert [d["mode"] for d in late] == ["SOE", "OPT"]
    assert sum(d["iters"] for d in late) == opt.LastIterNum
    assert all(d["infos"].shape == (d["iters"], 9) for d in late)
    assert early == []
    for st in passes:
        assert {"ad_s", "kkt_s", "ls_s", "read_s", "loop_s",
                "k1_launches"} <= set(st)
        assert all(st[k] > 0 for k in ("ad_s", "kkt_s", "loop_s"))
    assert passes[-1]["ls_s"] > 0        # OPT's line search (SOE has none)
    assert opt.LastFuncTime == pytest.approx(
        sum(st["ad_s"] + st["ls_s"] for st in passes), rel=1e-12)
    assert opt.LastKKTTime == pytest.approx(
        sum(st["kkt_s"] for st in passes), rel=1e-12)
    assert opt.LastFuncTime + opt.LastKKTTime <= opt.LastTotalTime
    stats = opt.LastFusedStats
    assert stats["iterations"] == late[-1]["iters"]
    assert stats["syncs"] >= 2 * stats["iterations"]

    opt.UseFused = False
    late.clear()
    assert p.optimize() == 0
    assert len(early) == opt.LastIterNum and late == []
    assert early[0]["mode"] == "OPT" and "dx" in early[0]

    opt.UseFused = True
    opt.set_PrintLevel(0)
    opt.CNRMode = opt.WideConsole = True
    capsys.readouterr()
    p.optimize()
    text = capsys.readouterr().out
    assert "KKT-inf" in text and "Hpert" in text and "\033" not in text
    opt.set_QPOrderingMode(1)
    opt.set_QPParams(1, 2)
