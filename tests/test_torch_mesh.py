"""Adaptive-mesh parity: the port's `OptimalControl/mesh.py`, re-sampling
and costates against the JAX package's, starting from one JAX-solved phase
whose iterate is copied into the port through `interop` (JAX reference:
CPU, x64, host loop, jitted calls).

Tolerances: segment coefficients, bounds and re-sampled trajectories
1e-12, error estimates 1e-8 relative (the "integrator" estimate, a
difference of two states that each integrator holds to an absolute 1e-12,
also gets an absolute 1e-13), costates 1e-8.  The mirrored
adaptive solves of `tests/test_adaptivemesh.py` hold flag, mesh iterations
and segment counts equal; see `test_hypersensitive_adaptive` for the
objective.
"""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_tpu.OptimalControl import mesh as jmesh
from asset_asrl_torch.OptimalControl import mesh as tmesh
from asset_asrl_torch.interop import load_phase_state, phase_state_to_numpy

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

XT0, XTF = 1.5, 1.0


def close(a, b, tol):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), \
        np.abs(a - b).max()


def errors_close(et, ej, est, rel=1e-8):
    close(et, ej, rel * np.abs(ej).max()
          + (1e-13 if est == "integrator" else 0.0))


def hypersens(ast, tmode, nsegs, tf, bounds=None, path_bounds=False,
              npts=200):
    """The hypersensitive problem of `tests/test_adaptivemesh.py`."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class HyperSens(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(1, 1)
            super().__init__(-XtU.XVar(0) + XtU.UVar(0), 1, 1)

    IG = [[XT0 * (1 - t / tf) + XTF * (t / tf), t, 0]
          for t in np.linspace(0, tf, npts)]
    phase = HyperSens().phase(tmode, IG, nsegs)
    if bounds is not None:
        phase.setTraj(IG, nsegs, bounds)
    phase.addBoundaryValue("First", [0, 1], [XT0, 0])
    phase.addBoundaryValue("Last", [0, 1], [XTF, tf])
    phase.addIntegralObjective(vf.Arguments(2).squared_norm() / 2, [0, 2])
    if path_bounds:
        phase.addLUVarBound("Path", 0, -50, 50)
        phase.addLUVarBound("Path", 2, -50, 50)
    phase.optimizer.PrintLevel = 2
    phase.optimizer.UseFused = False    # both held to the JAX host loop
    return phase


BOUNDS12 = np.concatenate([[0.0], np.cumsum(
    np.array([1, 1, 2, 3, 5, 6, 6, 5, 3, 2, 1, 1], float))]) / 36.0


@pytest.fixture(scope="module", params=["LGL3", "LGL5"])
def pair(request):
    """A JAX-solved phase on a non-uniform mesh and a port phase that holds
    its iterate, mesh, parameters and multipliers."""
    pj = hypersens(jast, request.param, 12, 40.0, BOUNDS12)
    assert pj.optimize() == 0
    pt = hypersens(tast, request.param, 12, 40.0, BOUNDS12)
    load_phase_state(pt, phase_state_to_numpy(pj))
    return pj, pt


def test_carried_state(pair):
    pj, pt = pair
    assert pt.numSegs == pj.numSegs == 12
    close(pt.seg_bounds, BOUNDS12, 1e-15)
    close(pt.taus, pj.taus, 1e-15)
    close(pt.makeSolverInput(), pj.makeSolverInput(), 1e-15)
    assert (pt.t0, pt.tf) == (pj.t0, pj.tf)


def test_segment_coefs(pair):
    pj, pt = pair
    for a, b in zip(tmesh._segment_coefs(pt), jmesh._segment_coefs(pj)):
        close(a, b, 1e-12)


@pytest.mark.parametrize("est", ["deboor", "residual", "integrator"])
def test_estimators(pair, est):
    pj, pt = pair
    fj = {"deboor": jmesh._deboor_errors, "residual": jmesh._residual_errors,
          "integrator": jmesh._integrator_errors}[est]
    ej = fj(pj)
    for p in pair:
        p.MeshErrorEstimator = est
    et = tmesh.segment_errors(pt)
    assert et.shape == (12,) and (et > 0).all()
    errors_close(et, ej, est)
    close(pt.returnTrajError(), et, 1e-15)
    errors_close(tmesh.trajectory_error(pt), jmesh.segment_errors(pj), est)


def test_deboor_error_weight(pair):
    pj, pt = pair
    assert tmesh._deboor_error_weight(pt._scheme, pt._cs) == \
        jmesh._deboor_error_weight(pj._scheme, pj._cs)


@pytest.mark.parametrize("crit", ["max", "avg", "mean", "geometric",
                                  "endtoend", "anything"])
def test_combine(crit):
    errs = np.random.default_rng(0).uniform(0, 1e-3, 17)
    errs[3] = 0.0
    assert tmesh._combine(errs, crit) == jmesh._combine(errs, crit)


def square_wave(p):
    p._traj = p._traj.copy()
    t = p._traj[:, p.XV]
    p._traj[:, p.XV + 1] = np.where((t > 9.0) & (t < 27.0), 1.0, -0.5) \
        + 1e-3 * t
    return p


def test_detect_switches(pair):
    pj, pt = pair
    keep = [p._traj for p in pair]
    try:
        sj, st = (m.detect_switches(square_wave(p))
                  for m, p in zip((jmesh, tmesh), pair))
        assert len(st) >= 2
        assert np.array_equal(st, sj)
        assert np.array_equal(tmesh.detect_switches(pt, 2.0),
                              jmesh.detect_switches(pj, 2.0))
    finally:
        for p, tr in zip(pair, keep):
            p._traj = tr


@pytest.mark.parametrize("case", ["deboor", "deboor_nobucket", "integrator",
                                  "switches", "reduce"])
def test_update_mesh(pair, case):
    keep = [p._traj for p in pair]
    try:
        out = []
        for m, p in zip((jmesh, tmesh), pair):
            p.MeshErrorEstimator = "integrator" if case == "integrator" \
                else "deboor"
            p.MeshBucketing = case != "deboor_nobucket"
            p.DetectControlSwitches = case == "switches"
            p.MeshTol = 1.0 if case == "reduce" else 1e-7
            if case == "switches":
                square_wave(p)
            errs = m.segment_errors(p)
            out.append((errs,) + m.update_mesh(p, errs))
        (ej, nj, bj), (et, nt, bt) = out
        assert nt == nj
        assert bt.shape == (nt + 1,) and (np.diff(bt) > 0).all()
        errors_close(et, ej, p.MeshErrorEstimator)
        close(bt, bj, 1e-7 if case == "integrator" else 1e-12)
    finally:
        for p, tr in zip(pair, keep):
            p._traj = tr
            p.MeshBucketing, p.DetectControlSwitches = True, False
            p.MeshTol = 1e-6


def fresh_pair(pair):
    pj, pt = pair
    state = phase_state_to_numpy(pj)
    qj = hypersens(jast, pj.TranscriptionMode, 12, 40.0, BOUNDS12)
    qt = hypersens(tast, pj.TranscriptionMode, 12, 40.0, BOUNDS12)
    return load_phase_state(qj, state), load_phase_state(qt, state)


def test_resample_nonuniform(pair):
    qj, qt = fresh_pair(pair)
    bounds = np.linspace(0, 1, 18) ** 1.5
    for q in (qj, qt):
        q.resampleTraj(17, seg_bounds=bounds)
    assert qt.numSegs == 17 and qt._need_transcribe
    close(qt.seg_bounds, qj.seg_bounds, 1e-15)
    close(qt._traj, qj._traj, 1e-12)
    for q in (qj, qt):
        q.refineTrajManual(9)
    close(qt._traj, qj._traj, 1e-12)
    close(qt.seg_bounds, np.linspace(0, 1, 10), 1e-15)
    for q in (qj, qt):
        q.refineTrajEqual(11)
    close(qt._traj, qj._traj, 1e-12)


def test_set_traj_bounds_forms(pair):
    qj, qt = fresh_pair(pair)
    IG = qj.returnTraj()
    bounds = np.linspace(0, 1, 8) ** 2
    qj.setTraj(IG, 7, bounds)
    qt.setTraj(IG, 7, seg_bounds=bounds)
    close(qt._traj, qj._traj, 1e-15)
    close(qt.taus, qj.taus, 1e-15)
    with pytest.raises(ValueError, match="seg_bounds"):
        qt.setTraj(IG, 7, bounds[:-1])


def test_costates(pair):
    pj, pt = pair
    cj = np.stack(pj.returnCostateTraj())
    # from the carried multipliers
    ct = np.stack(pt.returnCostateTraj())
    assert ct.shape == (pt.numNodes, 2)
    close(ct, cj, 1e-12)
    # from the port's own solve of the same problem
    qt = hypersens(tast, pj.TranscriptionMode, 12, 40.0, BOUNDS12)
    assert qt.optimize() == 0
    close(np.stack(qt.returnCostateTraj()), cj, 1e-8)
    # the costate of this problem is minus the control: H_u = u + lam
    assert np.abs(cj[1:-1, 0] + pj._traj[1:-1, 2]).max() < 0.2


def test_costates_need_a_solve():
    qt = hypersens(tast, "LGL3", 6, 40.0)
    with pytest.raises(RuntimeError, match="solve first"):
        qt.returnCostateTraj()


def test_integrator_estimator_failure_is_raised(pair, monkeypatch):
    """The port has no quiet switch to the residual estimator."""
    pj, pt = pair
    from asset_asrl_torch.Integrators import Integrator
    pt.MeshErrorEstimator = "integrator"

    def boom(self, x0s, tfs):
        raise RuntimeError("integrator failed")
    monkeypatch.setattr(Integrator, "integrate_parallel", boom)
    with pytest.raises(RuntimeError, match="integrator failed"):
        tmesh.segment_errors(pt)
    monkeypatch.setattr(
        Integrator, "integrate_parallel",
        lambda self, x0s, tfs: [np.full(3, np.nan) for _ in x0s])
    with pytest.raises(FloatingPointError, match="not finite"):
        tmesh.segment_errors(pt)


def count_mesh_iterations(monkeypatch, module):
    """Record (segments, objective) at every error estimate of an adaptive
    loop of `module`."""
    seen = []
    orig = module.segment_errors

    def spy(phase):
        seen.append((phase.numSegs, phase.optimizer.LastObjVal))
        return orig(phase)
    monkeypatch.setattr(module, "segment_errors", spy)
    return seen


def test_hypersensitive_adaptive(monkeypatch):
    """`tests/test_adaptivemesh.py::test_hypersensitive_adaptive` in both
    packages: LGL7, tf = 10000, MeshTol 1e-6, the default "integrator"
    estimator.  The flag, the number of mesh iterations and every mesh's
    segment count are equal, and the objective of every mesh before the
    last agrees to 1e-7.  On the last mesh it agrees to 2e-5: that mesh is
    laid out by error estimates that, over the flat middle of the
    trajectory, are at the rounding noise of the two integrators (1e-14
    and below, raised to the power 1/8 for the density), so the two
    packages place its bounds differently and each converges, KKT below
    1e-10 when polished, to its own mesh's quadrature value."""
    out = []
    for ast, module in ((jast, jmesh), (tast, tmesh)):
        seen = count_mesh_iterations(monkeypatch, module)
        p = hypersens(ast, "LGL7", 10, 10000.0, path_bounds=True, npts=1000)
        p.optimizer.set_OptLSMode("L1")
        p.optimizer.set_SoeLSMode("L1")
        p.setAdaptiveMesh(True)
        p.setMeshTol(1.0e-6)
        p.setMaxMeshIters(8)
        flag = p.solve_optimize()
        out.append((flag, seen, p.numSegs, p.optimizer.LastObjVal,
                    p.MeshConverged))
    (fj, sj, nj, oj, cj), (ft, st, nt, ot, ct) = out
    assert ft == fj == 0 and ct and cj
    assert [n for n, _ in st] == [n for n, _ in sj]
    assert nt == nj > 10
    for (_, a), (_, b) in zip(st[:-1], sj[:-1]):
        assert abs(a - b) <= 1e-7 * abs(b)
    assert abs(ot - oj) <= 2e-5 * abs(oj)
    Jstar = (np.sqrt(2) - 1) / 2 * XT0 ** 2 + (np.sqrt(2) + 1) / 2 * XTF ** 2
    assert abs(ot - Jstar) < 5e-3


def test_mesh_error_decreases():
    """`tests/test_adaptivemesh.py::test_mesh_error_decreases` in both
    packages: refinement reduces the re-integration error estimate."""
    errs = []
    for nsegs in (8, 32):
        pj, pt = (hypersens(ast, "LGL3", nsegs, 40.0) for ast in
                  (jast, tast))
        assert pj.optimize() == 0 and pt.optimize() == 0
        ej, et = jmesh.segment_errors(pj), tmesh.segment_errors(pt)
        errors_close(et, ej, "integrator", rel=1e-7)
        errs.append(np.max(et))
    assert errs[1] < errs[0] * 0.2, errs


@pytest.mark.parametrize("scaled", [False, True],
                         ids=["plain", "autoscaled"])
def test_remesh_at_equal_count_refreshes_consts(scaled):
    """A new mesh with the old segment count keeps the transcription (same
    structure key) and refreshes the consts only: the defect, spline,
    integral and region families must read the new bounds, as a fresh
    transcription on that mesh does."""
    def build():
        p = hypersens(tast, "LGL5", 10, 40.0, path_bounds=True)
        p.setControlMode("HighestOrderSpline")
        p.addIntegralParamFunction(tast.VectorFunctions.Arguments(1)[0] ** 2,
                                   [0], 0)
        p.setStaticParams([1.0])
        p.addLowerVarBound("Path", 1, -1.0)     # reads the node's time
        if scaled:
            p.setAutoScaling(True)
            p.setUnits(2.0, 10.0, 0.5)
        return p
    old = build()
    assert old.optimize() == 0
    nlp = old._nlp
    bounds = np.linspace(0, 1, 11) ** 1.3
    old.resampleTraj(10, seg_bounds=bounds)
    old.transcribe()
    assert old._nlp is nlp                      # refreshed, not rebuilt
    new = build()
    load_phase_state(new, phase_state_to_numpy(old))
    new.transcribe()
    for (fo, _), (fn, _) in zip(old._built, new._built):
        assert fo.name == fn.name
        nc = fn.consts.shape[1] - (fn.nin + fn.nout if scaled else 0)
        close(fo.consts[:, :nc], fn.consts[:, :nc], 1e-15)
    names = {f.name for f, _ in old._built}
    assert {"defects", "usplineH", "integral"} <= names
    assert old.optimize() == 0 and old._nlp is nlp


def test_mesh_error_plot():
    import matplotlib
    matplotlib.use("Agg")
    from asset_asrl_torch.OptimalControl.MeshErrorPlots import \
        PhaseMeshErrorPlot
    p = hypersens(tast, "LGL3", 8, 40.0)
    p.setMeshErrorEstimator("deboor")
    errs = PhaseMeshErrorPlot(p, show=False)
    close(errs, tmesh.segment_errors(p), 1e-15)


def test_mesh_api():
    p = hypersens(tast, "LGL3", 8, 40.0)
    p.setMeshTol(1e-5)
    p.setMaxMeshIters(3)
    p.setMeshErrorEstimator("deboor")
    p.setMeshErrorCriteria("avg")
    p.setMeshErrFactor(5.0)
    p.setMeshRedFactor(0.25)
    p.setMeshIncFactor(4.0)
    p.setMinSegments(6)
    p.setMaxSegments(64)
    p.setControlSwitchDetection(True, 0.2, 2)
    p.setThreads(4)
    p.PrintMeshInfo()
    assert (p.MeshTol, p.MaxMeshIters, p.MeshErrorEstimator,
            p.MeshErrorCriteria, p.MeshErrFactor, p.MeshRedFactor,
            p.MeshIncFactor, p.MinSegments, p.MaxSegments,
            p.DetectControlSwitches, p.SwitchTol,
            p.NumExtraAddsPerSwitch) == (
        1e-5, 3, "deboor", "avg", 5.0, 0.25, 4.0, 6, 64, True, 0.2, 2)
    integ = p.integrator
    assert integ is p.integrator and integ.DefStepSize == 0.1 * 40.0 / 8
    # jet_run follows JetJobMode through the adaptive loop
    p.setAdaptiveMesh(True)
    p.JetJobMode = "SolveOptimize"
    assert p.jet_run() == 0
    assert 8 < p.numSegs <= 64
