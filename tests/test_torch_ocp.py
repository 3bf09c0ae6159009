"""Multi-phase optimal control: the port's OptimalControlProblem against
the JAX package's.

* formation flying (two phases, PathToPath link) at 8 segments against the
  JAX host loop, then one factor/solve of the JAX package's final iterate
  side by side (carried over with `interop.iterate_of_problem`);
* the same at 80 segments: its border (85 wide) needs K1 above 64; and at
  256 segments (border 261) against a JAX solve of the same mesh;
* the link-objective routing and the StaticParams-link checks of
  `tests/test_pathtopath.py`, and every other link form at the initial
  guess (value + Jacobian of each link family);
* the 4-phase Delta III NLP at its initial guess: block structure, the
  residual and the assembled KKT blocks (Jacobians and Hessians) through
  the JAX package's jitted evaluators;
* the Delta III solve itself (slow: ~1 minute on the CPU; `chip_smoke.py`
  runs it on the card), and the adaptive-mesh Delta III of
  `tests/test_delta3.py` (slow);
* an index-selected link on an ODEParams region, and the multi-phase
  adaptive loop and its setters on a small problem.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_tpu.Solvers import nlp as jnlp
from asset_asrl_torch.interop import iterate_of_problem, solver_input
from asset_asrl_torch.Solvers import nlp as tnlp
from chip_smoke import (D3, DELTA3_ADAPTIVE, DELTA3_FUSED, FORMATION,
                        build_delta3, build_formation)

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

CONVERGED = 0


def close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= tol * max(
        1.0, np.abs(a[fin]).max(initial=0.0))


def quiet(ocp):
    ocp.optimizer.set_PrintLevel(2)
    ocp.optimizer.UseFused = False
    return ocp


@pytest.fixture(scope="module")
def formation8():
    (oj, _, _), (ot, pa, pb) = (build_formation(jast, 8),
                                build_formation(tast, 8))
    return quiet(oj), quiet(ot), oj.optimize(), ot.optimize(), pa, pb


def test_formation_8_matches_jax(formation8):
    oj, ot, fj, ft, pa, pb = formation8
    flag0, it0, obj0, b0 = FORMATION[8]
    assert fj == ft == flag0 == CONVERGED
    assert oj.optimizer.LastIterNum == ot.optimizer.LastIterNum == it0
    assert abs(ot.optimizer.LastObjVal - oj.optimizer.LastObjVal) \
        <= 1e-8 * obj0
    assert abs(ot.optimizer.LastObjVal - obj0) <= 1e-8 * obj0
    bj, bt = oj.optimizer.kkt.bs, ot.optimizer.kkt.bs
    assert (bj.K, bj.W, bj.b) == (bt.K, bt.W, bt.b) == (18, 8, b0)
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    assert np.allclose(gap, 0.2, atol=1e-6)
    assert np.abs(ot.makeSolverInput() - oj._make_input()).max() < 1e-8


def test_formation_8_factor_solve_side_by_side(formation8):
    """The JAX package's final iterate, factored and solved by both
    packages' block KKT backends: same inertia, same step.  The link rows
    at the end nodes repeat the boundary values, so the regularization is
    raised (delta 1e-2, gammaE 1e-3) to make the step well defined."""
    oj, ot, _, _, _, _ = formation8
    x, s, lamE, lamI = iterate_of_problem(oj, device="cpu")
    assert x.shape[0] == ot._nlp.numPrimal
    rng = np.random.default_rng(5)
    sig = rng.uniform(0.5, 2.0, size=s.shape[0])
    rx = rng.normal(size=x.shape[0])
    rE = rng.normal(size=lamE.shape[0])
    kj, kt = oj.optimizer.kkt, ot.optimizer.kkt
    facj, nj = kj.factor(jnp.asarray(x.numpy()), jnp.asarray(lamE.numpy()),
                         jnp.asarray(lamI.numpy()), 1.0, jnp.asarray(sig),
                         1e-2, 1e-3)
    fact, nt = kt.factor(x, lamE, lamI, 1.0, torch.tensor(sig), 1e-2, 1e-3)
    assert nj == nt
    dxj, dlj = kj.solve(facj, jnp.asarray(rx), jnp.asarray(rE))
    dxt, dlt = kt.solve(fact, torch.tensor(rx), torch.tensor(rE))
    close(dxj, dxt, 1e-10)
    close(dlj, dlt, 1e-10)


def test_formation_80_border_wider_than_64():
    """b = 85 > 64: the border goes through K1 at its full width."""
    flag0, it0, obj0, b0 = FORMATION[80]
    ocp, pa, pb = build_formation(tast, 80)
    quiet(ocp)
    assert ocp.optimize() == flag0 == CONVERGED
    assert ocp.optimizer.kkt.bs.b == b0 == 85
    assert ocp.optimizer.LastIterNum == it0
    assert abs(ocp.optimizer.LastObjVal - obj0) <= 1e-8 * obj0
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    assert np.allclose(gap, 0.2, atol=1e-6)


def test_formation_256_matches_jax():
    """256 segments a phase (K 514, W 8, border 261: four times the wide
    kernel's panel count of the 80-segment case) against the JAX host
    loop on the same mesh: flag, iterations, objective to 1e-8."""
    flag0, it0, obj0, b0 = FORMATION[256]
    (oj, _, _), (ot, pa, pb) = (build_formation(jast, 256),
                                build_formation(tast, 256))
    fj, ft = quiet(oj).optimize(), quiet(ot).optimize()
    assert fj == ft == flag0 == CONVERGED
    assert oj.optimizer.LastIterNum == ot.optimizer.LastIterNum == it0
    assert abs(oj.optimizer.LastObjVal - obj0) <= 1e-8 * obj0
    assert abs(ot.optimizer.LastObjVal - oj.optimizer.LastObjVal) \
        <= 1e-8 * obj0
    bj, bt = oj.optimizer.kkt.bs, ot.optimizer.kkt.bs
    assert (bj.K, bj.W, bj.b) == (bt.K, bt.W, bt.b) == (514, 8, b0)
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    assert np.allclose(gap, 0.2, atol=1e-6)


def test_resolve_refreshes_consts():
    """A second solve with the structure unchanged reuses the NLP and the
    KKT backend (consts refreshed only) and stays converged."""
    ocp, _, _ = build_formation(tast, 8)
    quiet(ocp).optimize()
    nlp, kkt = ocp._nlp, ocp.optimizer.kkt
    assert ocp.optimize() == CONVERGED
    assert ocp._nlp is nlp and ocp.optimizer.kkt is kkt
    assert ocp.optimizer.LastIterNum <= 2


def _pathtopath_pair(ast, nsegs=8, sp=None):
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments

    class DI(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    def phase(x0, xf):
        ts = np.linspace(0, 2, 20)
        IG = [[x0 + (xf - x0) * t / 2, (xf - x0) / 2, t, 0.0] for t in ts]
        ph = DI().phase("LGL3", IG, nsegs)
        ph.addBoundaryValue("Front", [0, 1, 2], [x0, 0, 0])
        ph.addBoundaryValue("Back", [0, 1, 2], [xf, 0, 2])
        ph.addIntegralObjective(Args(1)[0] ** 2, [3])
        return ph
    pa = phase(0.0, 1.0)
    pb = phase(0.2, 1.2) if sp is None else phase(0.0, 1.0)
    if sp is not None:
        pb.setStaticParams(sp)
    ocp = oc.OptimalControlProblem()
    ocp.addPhase(pa)
    ocp.addPhase(pb)
    return quiet(ocp), pa, pb


def test_path_link_objective_routing():
    """`test_pathtopath.test_path_link_objective` on the port: a Path link
    objective adds an objective family and no constraint rows."""
    base, _, _ = _pathtopath_pair(tast)
    base.transcribe()
    ocp, pa, pb = _pathtopath_pair(tast)
    A = tast.VectorFunctions.Arguments(8)
    ocp.addLinkObjective(((A[0] - A[4]) ** 2) * 10.0,
                         [(pa, "Path"), (pb, "Path")])
    ocp.transcribe()
    assert ocp._nlp.numEq == base._nlp.numEq
    assert ocp._nlp.numIq == base._nlp.numIq
    assert len(ocp._nlp.objectives) == len(base._nlp.objectives) + 1
    assert ocp.optimize() == CONVERGED
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    assert gap.min() < 0.1
    assert abs(gap[0] - 0.2) < 1e-6 and abs(gap[-1] - 0.2) < 1e-6


def test_path_link_with_staticparam_region():
    """`test_pathtopath.test_path_link_with_staticparam_region` on the
    port, and its rows equal to the JAX package's."""
    rows = []
    for ast in (jast, tast):
        ocp, pa, pb = _pathtopath_pair(ast, 4, sp=[0.25])
        A = ast.VectorFunctions.Arguments(2)
        ocp.addLinkEqualCon(A[0] - A[1],
                            [(pb, "StaticParams", [], [], [0]),
                             (pa, "Path", [0], [], [])])
        ocp.transcribe()
        x0 = solver_input(ocp)
        _, cE, _ = ocp._nlp.eval_obj_cons(
            jnp.asarray(x0) if ast is jast else torch.tensor(x0))
        n = pa.numNodes
        got = np.asarray(cE)[-n:]
        want = 0.25 - np.asarray(pa.returnTraj())[:, 0]
        assert np.allclose(got, want, atol=1e-12)
        rows.append(np.asarray(cE))
    close(rows[0], rows[1])


def _link_forms(ast):
    """Two phases with link parameters and every non-path link form."""
    ocp, pa, pb = _pathtopath_pair(ast, 4, sp=[0.25, 0.5])
    ocp.setLinkParams([0.3, 1.1])
    A = ast.VectorFunctions.Arguments
    ocp.addForwardLinkEqualCon(pa, pb, [1])
    ocp.addDirectLinkEqualCon(A(2)[0] * A(2)[1] - 0.1, pa, "Back", [0],
                              pb, "Front", [3])
    ocp.addDirectLinkEqualCon(pb, "StaticParams", [0], pa, "Back", [1])
    ocp.addLinkEqualCon(A(4)[0] - A(4)[1] * A(4)[3] + A(4)[2],
                        [(pa, "Back", [0, 2]), (pb, "Front", [], [], [1])],
                        [1])
    ocp.addLinkEqualCon(A(9)[0] - A(9)[4] + A(9)[8], pa, "Back", pb, "Front",
                        pb, "LinkParams")
    ocp.addLinkParamEqualCon(A(2)[0] * A(2)[1] - 0.4, [0, 1])
    ocp.addLinkObjective(A(10)[0] * A(10)[9], [(pa, "Front"),
                                               (pb, "Back")])
    return ocp


def test_solver_vector_round_trip():
    """`collectSolverOutput(V)` then `makeSolverInput()` gives V back
    bitwise: both phases' nodes and times, the static parameters and the
    link parameters; and the solve's host seconds outside PSIOPT are in
    `LastSolveStats`."""
    ocp = _link_forms(tast)
    ocp.transcribe()
    V0 = ocp.makeSolverInput()
    V = V0 * (1.0 + 1e-3 * np.random.default_rng(7).normal(size=V0.size))
    ocp.collectSolverOutput(V)
    assert np.array_equal(ocp.makeSolverInput(), V)
    assert np.array_equal(ocp.returnLinkParams(), V[-2:])
    assert ocp.Phases[1].returnStaticParams()[1] == V[ocp._lp_offset - 1]
    ocp.optimizer.MaxIters = 2
    ocp.optimize()
    assert set(ocp.LastSolveStats) == {"transcribe_s", "io_s"}
    assert all(v > 0 for v in ocp.LastSolveStats.values())


def test_link_forms_match_jax():
    oj, ot = _link_forms(jast), _link_forms(tast)
    oj.transcribe()
    ot.transcribe()
    x = oj._make_input()
    assert np.array_equal(x, ot.makeSolverInput())
    nj, nt = oj._nlp, ot._nlp
    assert (nj.numPrimal, nj.numEq, nj.numIq) == \
        (nt.numPrimal, nt.numEq, nt.numIq)
    links_j = [f for f in nj.eqcons + nj.objectives
               if f.name in ("link", "linkparam")]
    links_t = [f for f in nt.eqcons + nt.objectives
               if f.name in ("link", "linkparam")]
    assert len(links_j) == len(links_t) == 7
    rng = np.random.default_rng(3)
    for fj, ft in zip(links_j, links_t):
        assert fj.name == ft.name and np.array_equal(fj.Vidx, ft.Vidx)
        xg = x[fj.Vidx] + 0.01 * rng.normal(size=fj.Vidx.shape)
        vj, jj = jax.jit(jnlp._family_valjac(fj.fun))(
            jnp.asarray(xg), jnp.asarray(fj.consts))
        vt, jt = tnlp._family_valjac(ft.fun)(torch.tensor(xg),
                                             torch.tensor(ft.consts))
        close(vj, vt)
        close(jj, jt)
    bj, bt = oj.optimizer.kkt.bs, ot.optimizer.kkt.bs
    assert (bj.K, bj.W, bj.b) == (bt.K, bt.W, bt.b)


# -------------------------------------------------------------- Delta III
@pytest.fixture(scope="module")
def delta3_40():
    oj, _ = build_delta3(jast, 40)
    ot, _ = build_delta3(tast, 40)
    for o in (oj, ot):
        quiet(o).transcribe()
    return oj, ot


def test_delta3_structure(delta3_40):
    oj, ot = delta3_40
    bj, bt = oj.optimizer.kkt.bs, ot.optimizer.kkt.bs
    assert (bj.K, bj.W, bj.b) == (bt.K, bt.W, bt.b) == (164, 25, 11)
    assert np.array_equal(bj.rhs_perm(), bt.rhs_perm())
    nj, nt = oj._nlp, ot._nlp
    assert (nj.numPrimal, nj.numEq, nj.numIq) == \
        (nt.numPrimal, nt.numEq, nt.numIq)
    assert [f.name for f in nj.eqcons] == [f.name for f in nt.eqcons]
    for fj, ft in zip(nj.eqcons + nj.iqcons + nj.objectives,
                      nt.eqcons + nt.iqcons + nt.objectives):
        assert np.array_equal(fj.Vidx, ft.Vidx)


def test_delta3_nlp_at_initial_guess(delta3_40):
    """Residual and assembled KKT blocks (constraint Jacobians and
    Lagrangian Hessian) at the initial guess with seeded multipliers."""
    oj, ot = delta3_40
    x = oj._make_input()
    nlp = oj._nlp
    rng = np.random.default_rng(11)
    lamE = rng.normal(size=nlp.numEq)
    lamI = rng.uniform(0.1, 1.0, size=nlp.numIq)
    sig = rng.uniform(0.5, 2.0, size=nlp.numIq)
    kj, kt = oj.optimizer.kkt, ot.optimizer.kkt
    xj, lEj, lIj = (jnp.asarray(a) for a in (x, lamE, lamI))
    xt, lEt, lIt = (torch.tensor(a) for a in (x, lamE, lamI))
    rj = kj.eval_resid(xj, lEj, lIj, 1.0)
    rt = kt.eval_resid(xt, lEt, lIt, 1.0)
    for i in (0, 2, 3, 4):          # obj, cE, cI, rd
        close(rj[i], rt[i], 1e-11)
    consts = nlp.consts_dev()
    famj = jax.jit(kj._ad_impl)(xj, lEj, lIj, jnp.asarray(1.0), consts)[4]
    blocks_j = jax.jit(kj._blocks_impl)(famj, jnp.asarray(sig))
    famt = kt._eval_core(xt[None], lEt[None], lIt[None], 1.0,
                         ot._nlp.consts_dev(), want_hess=True)[4]
    blocks_t = kt._blocks_impl(famt, torch.tensor(sig)[None])
    for a, b in zip(blocks_j, blocks_t):
        close(a, b[0], 1e-11)


@pytest.mark.slow
def test_delta3_solve_40():
    """The default path (the fused loop) of `solve_optimize()` at 40
    segments a phase: the JAX package's flag, and its final mass to 1e-6
    relative, above the 8.5e-7 that either package's mass spreads under
    1e-10 perturbations of x0; the iterations are not held (33-55 there,
    `chip_smoke.DELTA3_FUSED`)."""
    flag0, mass0 = DELTA3_FUSED
    ocp, phases = build_delta3(tast, 40)
    ocp.optimizer.set_PrintLevel(2)
    assert ocp.optimizer.UseFused
    assert ocp.solve_optimize() == flag0 == CONVERGED
    mass = phases[3].returnTraj()[-1][6] * D3["Mstar"]
    assert abs(mass - mass0) <= 1e-6 * mass0


@pytest.mark.slow
def test_delta3_adaptive():
    """`tests/test_delta3.py::test_delta3_launch` in the port: the JAX host
    loop's flag, per-phase final segment counts and final mass, which is
    within 0.01 kg of the published optimum."""
    flag0, segs0, mass0 = DELTA3_ADAPTIVE
    ocp, phases = build_delta3(tast, 40, adaptive=True)
    quiet(ocp)
    assert ocp.solve_optimize() == flag0 == CONVERGED
    assert [p.numSegs for p in phases] == segs0
    mass = phases[3].returnTraj()[-1][6] * D3["Mstar"]
    assert abs(mass - mass0) <= 1e-7 * mass0
    assert abs(mass - 7529.749892668763) < 0.01


def _param_linked(ast, form):
    """Two phases with one ODE parameter each (the control's gain), the
    first pinned to 1.5, and a link that makes the second equal to it."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class Gain(oc.ODEBase):
        def __init__(self):
            a = oc.ODEArguments(2, 1, 1)
            super().__init__(vf.stack([a.XVar(1), a.UVar(0) * a.PVar(0)]),
                             2, 1, 1)

    def phase(xf, p):
        IG = [[xf * t, xf, t, 0.0, p] for t in np.linspace(0, 1, 10)]
        ph = Gain().phase("LGL3", IG, 6)
        ph.addBoundaryValue("Front", [0, 1, 2], [0, 0, 0])
        ph.addBoundaryValue("Back", [0, 1, 2], [xf, 0, 1])
        ph.addIntegralObjective(vf.Arguments(1)[0] ** 2, [3])
        return ph

    pa, pb = phase(1.0, 1.0), phase(2.0, 3.0)
    pa.addBoundaryValue("ODEParams", [0], [1.5])
    ocp = oc.OptimalControlProblem()
    ocp.addPhase(pa)
    ocp.addPhase(pb)
    A = vf.Arguments(2)
    if form == "indexed":
        ocp.addLinkEqualCon(A[0] - A[1], [(pa, "ODEParams", [], [0], []),
                                          (pb, "ODEParams", [], [0], [])],
                            [])
    else:
        ocp.addLinkEqualCon(A[0] - A[1], pa, "ODEParams", pb, "ODEParams")
    return quiet(ocp), pa, pb


def test_indexed_link_on_odeparams_region():
    """An index-selected link on an ODEParams region.  The JAX package
    decodes the two gathered parameters through the node layout, reads
    past them (its out-of-range reads clamp) and ends with the second
    parameter on both sides: a row that is identically zero, so the link
    is lost without an error.  The port reads the parameter vector itself
    and gives what the JAX package gives for the same link written in the
    region form, which it decodes as parameters."""
    oj, _, _ = _param_linked(jast, "indexed")
    oj.transcribe()
    fam = oj._nlp.eqcons[-1]
    g = jnp.asarray(oj._make_input()[fam.Vidx[0]])
    c = jnp.asarray(fam.consts[0])
    assert np.asarray(g).tolist() == [1.0, 3.0]
    assert float(jax.jit(fam.fun)(g, c)[0]) == 0.0
    assert not np.asarray(jax.jit(jax.jacfwd(fam.fun))(g, c)).any()

    ot, pa, pb = _param_linked(tast, "indexed")
    ot.transcribe()
    famt = ot._nlp.eqcons[-1]
    assert np.array_equal(famt.Vidx, fam.Vidx)
    gt = tast.config.tensor([1.0, 3.0])
    ct = tast.config.tensor(famt.consts[0])
    assert float(famt.fun(gt, ct)[0]) == -2.0
    close(torch.func.jacfwd(famt.fun)(gt, ct).numpy(), [[1.0, -1.0]])

    rj, qa, qb = _param_linked(jast, "region")
    assert rj.optimize() == ot.optimize() == CONVERGED
    assert abs(pb._odeparams[0] - 1.5) < 1e-8 \
        and abs(qb._odeparams[0] - 1.5) < 1e-8
    assert abs(ot.optimizer.LastIterNum - rj.optimizer.LastIterNum) <= 1
    close(ot.optimizer.LastObjVal, rj.optimizer.LastObjVal, 1e-8)
    close(np.asarray(pb.returnTraj()), np.asarray(qb.returnTraj()), 1e-7)


def test_ocp_adaptive_loop_and_setters(monkeypatch):
    """The multi-phase adaptive loop on formation flying without its link
    (the PathToPath link needs equal node counts): both packages refine
    the same phases to the same segment counts and objective."""
    from asset_asrl_tpu.OptimalControl import mesh as jmesh
    from asset_asrl_torch.OptimalControl import mesh as tmesh
    out = []
    for ast, module in ((jast, jmesh), (tast, tmesh)):
        ocp, pa, pb = build_formation(ast, 6)
        ocp._link_specs.clear()
        quiet(ocp)
        ocp.setAdaptiveMesh(True)
        ocp.setMeshTol(1e-9)
        for p in (pa, pb):
            p.setMeshErrorEstimator("deboor")
            p.setMaxMeshIters(2)
        assert pa.AdaptiveMesh and pb.MeshTol == 1e-9
        ocp.setThreads(2)
        ocp.PrintMeshInfo()
        ocp.setJetJobMode("optimize")
        calls = []
        orig = module.update_mesh
        monkeypatch.setattr(module, "update_mesh",
                            lambda p, e, o=orig, c=calls:
                            (c.append(p.numSegs), o(p, e))[1])
        flag = ocp.jet_run()
        out.append((flag, calls, pa.numSegs, pb.numSegs,
                    ocp.optimizer.LastObjVal, pa.MeshConverged))
    (fj, cj, aj, bj, oj, mj), (ft, ct, at, bt, ot, mt) = out
    assert ft == fj == CONVERGED
    assert ct == cj and len(ct) >= 2
    assert (at, bt, mt) == (aj, bj, mj) and at > 6
    close(ot, oj, 1e-8)
