"""Scenario batches in the port (`asset_asrl_torch.parallel`), mirroring
`tests/test_parallel.py`: the iteration step, a batched step against the
single one, and `solve_ensemble` (the fused PSIOPT loop with a lane axis)
against the port's per-lane `optimize()` and the JAX package's
`solve_ensemble` (reference calls jitted)."""

import jax
import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_tpu import parallel as jpar
from asset_asrl_torch import parallel as tpar

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


def double_integrator(ast, nsegs=12, xf=1.0):
    """The LGL3 double-integrator phase of `tests/test_parallel.py`, built
    with either package's namespace (`xf`: the final position)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class Cart(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    ts = np.linspace(0, 2, 30)
    IG = [[t / 2, 0.5, t, 0.0] for t in ts]
    phase = Cart().phase("LGL3", IG, nsegs)
    phase.addBoundaryValue("Front", [0, 1, 2], [0, 0, 0])
    phase.addBoundaryValue("Back", [0, 1, 2], [xf, 0, 2])
    phase.addLUVarBound("Path", 3, -4.0, 4.0)
    phase.addIntegralObjective(vf.Arguments(1)[0] ** 2, [3])
    phase.optimizer.set_PrintLevel(2)
    return phase


def to_np(state):
    return [np.asarray(v.detach().numpy() if torch.is_tensor(v) else v)
            for v in state]


def test_iteration_step_converges():
    """25 full steps from `init_state` converge (as in the JAX test) and
    land on the JAX package's iterate."""
    pt, pj = double_integrator(tast), double_integrator(jast)
    step = tpar.make_iteration_step(pt)
    state = tpar.init_state(pt)
    jstep = jax.jit(jpar.make_iteration_step(pj))
    jstate = jpar.init_state(pj)
    for _ in range(25):
        state, info = step(state)
        jstate, _ = jstep(jstate)
    kkt, econ, icon, barr = info.numpy()
    assert econ < 1e-8 and kkt < 1e-5, (kkt, econ)
    for a, b in zip(to_np(state), to_np(jstate)):
        assert np.abs(a - b).max(initial=0.0) <= 1e-8 * max(
            1.0, np.abs(b).max(initial=0.0))


def test_batched_step_matches_single():
    """Lane 2 of a 4-lane batched step equals one problem stepped alone
    from the same start (5 steps, 1e-12)."""
    phase = double_integrator(tast)
    step = tpar.make_iteration_step(phase)
    vstep = tpar.make_batched_step(phase)
    base = tpar.init_state(phase)
    B = 4
    rng = np.random.default_rng(0)
    xb = torch.stack([base[0] + torch.tensor(rng.normal(
        size=base[0].shape) * 1e-3) for _ in range(B)])
    bstate = (xb,) + tuple(v.expand((B,) + v.shape) for v in base[1:])
    for _ in range(5):
        bstate, binfo = vstep(bstate)
    state = (xb[2],) + tuple(base[1:])
    for _ in range(5):
        state, info = step(state)
    assert binfo.shape == (B, 4)
    assert torch.allclose(bstate[0][2], state[0], atol=1e-12, rtol=0)
    assert torch.allclose(binfo[2], info, atol=1e-12, rtol=0)


@pytest.fixture(scope="module")
def ensembles():
    """B = 3 perturbed starts (`tests/test_parallel.py`'s seed) through
    both packages' `solve_ensemble`."""
    out = {}
    for name, ast, mod in (("jax", jast, jpar), ("torch", tast, tpar)):
        phase = double_integrator(ast)
        phase.transcribe()
        base = np.asarray(phase.makeSolverInput())
        rng = np.random.default_rng(3)
        perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(3)]
        out[name] = (phase, base, perts,
                     mod.solve_ensemble(phase, perturb_states=perts))
    return out


def test_ensemble_matches_per_lane_optimize(ensembles):
    """Every lane equals the port's own optimize() of that start: flags
    and iterations exact, x to 1e-10."""
    phase, base, perts, res = ensembles["torch"]
    opt = phase.optimizer
    assert set(res) == {"x", "flags", "iters", "objs", "infos", "lamE",
                        "lamI", "s"}
    for i, p in enumerate(perts):
        xi = opt.optimize(base + p)
        assert int(res["flags"][i]) == opt.ConvergeFlag == 0, i
        assert int(res["iters"][i]) == opt.LastIterNum, i
        assert np.abs(res["x"][i] - xi).max() <= 1e-10, i
        assert abs(res["objs"][i] - opt.LastObjVal) <= 1e-10


def test_autoscaled_ensemble_lanes_match_solo():
    """An ill-conditioned problem: the auto-scaled Goddard rocket of
    `test_torch_autoscale.py` (32 LGL3 segments), 4 perturbed starts
    (`default_rng(3)` x 1e-3 on the scaled solver input) in one ensemble.
    A lane's root and border products are batched where its solo solve's
    are plain (`kkt_block._mv`), so it may round differently; every lane
    still takes its solo solve's flag and iterations (23 to 30), x agrees
    to 1e-9 relative and the objective to 1e-10 (measured on the CPU:
    1.1e-10 and 2.2e-12)."""
    from test_torch_autoscale import initial_guess, single_phase
    ode, IG = initial_guess(tast)
    phase = single_phase(tast, ode, IG, 32, True)
    opt = phase.optimizer
    opt.UseFused = True
    phase.transcribe()
    base = np.asarray(phase.makeSolverInput())
    rng = np.random.default_rng(3)
    perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(4)]
    res = tpar.solve_ensemble(phase, perturb_states=perts)
    assert len(set(res["iters"].tolist())) > 1
    for i, p in enumerate(perts):
        xi = opt.optimize(base + p)
        assert int(res["flags"][i]) == opt.ConvergeFlag == 0, i
        assert int(res["iters"][i]) == opt.LastIterNum, i
        assert np.abs(res["x"][i] - xi).max() <= 1e-9 * np.abs(xi).max(), i
        assert abs(res["objs"][i] - opt.LastObjVal) \
            <= 1e-10 * abs(opt.LastObjVal), i


def test_ensemble_matches_jax_ensemble(ensembles):
    """The port's ensemble against the JAX package's: flags and
    iterations exact, x, multipliers and objectives to 1e-8."""
    rj, rt = ensembles["jax"][3], ensembles["torch"][3]
    assert np.array_equal(rj["flags"], rt["flags"])
    assert np.array_equal(rj["iters"], rt["iters"])
    for k in ("x", "lamE", "lamI", "s", "objs"):
        assert np.abs(rj[k] - rt[k]).max() <= 1e-8 * max(
            1.0, np.abs(rj[k]).max()), k
    n = int(rj["iters"].max())
    assert np.abs(rj["infos"][:, :n, :3] - rt["infos"][:, :n, :3]).max() \
        <= 1e-8 * np.abs(rj["infos"][:, :n, :3]).max()


def test_converged_lane_is_frozen():
    """A lane that converges early keeps its state bitwise while the
    others run on: lane 0 starts at the solution, the others far from it
    (many more iterations), and lane 0's x, multipliers and info rows are
    the same whether the batch stops at lane 0's iteration count or runs
    its slow lanes to the end."""
    phase = double_integrator(tast)
    guess = phase.makeSolverInput()
    assert phase.optimize() == 0
    solved = phase.makeSolverInput()
    rng = np.random.default_rng(4)
    x0s = [solved] + [x + rng.normal(size=x.shape) * 3.0
                      for x in (guess, solved)]
    full = tpar.solve_ensemble(phase, x0s=x0s)
    n0 = int(full["iters"][0])
    assert n0 < full["iters"][1:].min()
    phase.optimizer.MaxIters = n0
    capped = tpar.solve_ensemble(phase, x0s=x0s)
    assert capped["iters"].tolist() == [n0] * 3
    assert capped["flags"][0] == full["flags"][0] == 0
    for k in ("x", "lamE", "lamI", "s"):
        assert np.array_equal(capped[k][0], full[k][0]), k
    assert np.array_equal(capped["infos"][0], full["infos"][0][:n0])
    assert not full["infos"][0][n0:].any()


def test_mesh_is_not_ignored():
    """A mesh splits the scenario axis: a batch that does not split over
    its axis, or an axis the mesh lacks, raises instead of running
    unsharded."""
    from asset_asrl_torch.distributed import chain_mesh
    phase = double_integrator(tast, 4)
    base = phase.makeSolverInput()
    mesh = chain_mesh(axis="scenario", shards=2)
    with pytest.raises(ValueError, match="do not split"):
        tpar.solve_ensemble(phase, perturb_states=[0 * base] * 3, mesh=mesh)
    state = tpar.init_state(phase)
    batch = tuple(torch.stack([v] * 3) for v in state)
    with pytest.raises(ValueError, match="do not split"):
        tpar.make_batched_step(phase, mesh=mesh)(batch)
    with pytest.raises(ValueError, match="no axis"):
        tpar.make_batched_step(phase, mesh=chain_mesh(axis="seg"))(batch)


def goddard_three_phase(ast):
    """The three-phase Goddard rocket of `tests/test_fullproblems2.py::
    test_goddard_multiphase` (LGL3, 24 segments a phase, a singular arc
    held by a path constraint), built with either package's namespace in
    that file's order of operations."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments
    g0, Lstar, Tstar, Mstar = 32.2, 10000.0, 60.0, 1
    Vstar = Lstar / Tstar
    Fstar = Mstar * Lstar / Tstar ** 2
    Astar = Lstar / Tstar ** 2
    sigmastar = Mstar / Lstar
    h_ref, g, Tmag = 23800 / Lstar, g0 / Astar, 200 / Fstar
    c, sigma, m0, mf = 1580.94 / Vstar, 5.4915e-5 / sigmastar, 3, 1

    class GoddardRocket(oc.ODEBase):
        def __init__(self):
            args = oc.ODEArguments(3, 1)
            h, v, m = args.XVec().tolist()
            u = args.UVar(0)
            vdot = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) / m - g
            super().__init__(vf.stack(v, vdot, -u * Tmag / c), 3, 1)

    ode = GoddardRocket()
    integ = ode.integrator(.01, vf.ifelse(Args(1)[0] > mf, 1, 0), [2])
    X0 = np.zeros(5)
    X0[2] = m0
    X0[4] = 1
    IG = integ.integrate_dense(X0, 60 / Tstar, 500, lambda x: x[1] < 0)

    def PathCon():
        h, v, m, u = Args(4).tolist()
        t1 = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) - g * m
        t2 = (m * g / (1 + 4 * (c / v) + 2 * (c / v) ** 2)) * (
            c * c * (1 + v / c) / (h_ref * g) - 1.0 - 2.0 * c / v)
        return t1 - t2

    n = len(IG) // 3
    p1 = ode.phase("LGL3", IG[0:n], 24)
    p1.addBoundaryValue("Front", range(0, 4), IG[0][0:4])
    p1.addBoundaryValue("Path", [4], [1])
    p2 = ode.phase("LGL3", IG[n:2 * n], 24)
    p2.setControlMode("NoSpline")
    p2.addLUVarBound("Path", 4, 0.0, 1.0, 1.0)
    p2.addEqualCon("Path", PathCon(), [0, 1, 2, 4])
    p3 = ode.phase("LGL3", IG[2 * n:-1], 24)
    p3.addBoundaryValue("Path", [4], [0])
    p3.addBoundaryValue("Back", [1, 2], [0, mf])
    p3.addValueObjective("Back", 0, -1.0)
    ocp = oc.OptimalControlProblem()
    for p in (p1, p2, p3):
        ocp.addPhase(p)
    ocp.addForwardLinkEqualCon(p1, p3, range(0, 4))
    for p in (p1, p2, p3):
        p.addLowerDeltaTimeBound(0)
    ocp.optimizer.PrintLevel = 2
    return ocp


@pytest.mark.slow
def test_goddard_diverging_rate_matches_jax():
    """The DIVERGING rate of the chaotic three-phase Goddard problem
    (ROADMAP queue 3) in each package: `solve_ensemble` of 128 lanes from
    the initial guess plus itself times 1e-10 N(0, 1), the same lanes in
    both.
    Measured on the CPU: JAX 8 of 128 lanes DIVERGING, the port 12 of 128,
    a two-proportion z of 0.93 (one-sided p 0.18): the port's rate is not
    above JAX's beyond the sampling noise.  The test holds that: the
    one-sided p-value must stay above 0.05.  (About 11 minutes on the
    CPU; slow-marked, so tier-1 does not run it.)"""
    from math import erf, sqrt
    counts = []
    for ast, par in ((jast, jpar), (tast, tpar)):
        ocp = goddard_three_phase(ast)
        ocp.transcribe()
        ocp._need_transcribe = False        # the JAX solve_ensemble asks
        base = np.asarray(ocp._make_input())
        rng = np.random.default_rng(2026)
        x0s = [base + base * 1e-10 * rng.normal(size=base.shape)
               for _ in range(128)]
        res = par.solve_ensemble(ocp, x0s=x0s)
        flags = np.asarray(res["flags"])
        print(ast.__name__, "flags", np.bincount(flags, minlength=4))
        counts.append(int((flags == 3).sum()))
    nj, nt = counts
    p = (nj + nt) / 256
    z = (nt - nj) / 128 / sqrt(p * (1 - p) * 2 / 128) if 0 < p < 1 else 0.0
    p_one_sided = 0.5 * (1 - erf(z / sqrt(2)))
    print(f"DIVERGING: JAX {nj}/128, port {nt}/128, z {z:.3f}, "
          f"one-sided p {p_one_sided:.3f}")
    assert p_one_sided > 0.05
