"""Units and auto-scaling parity: `setUnits`, `var_units`, the row and
objective scales of `_apply_autoscale`, and auto-scaled solves of the
Goddard rocket of `examples/UpdatedInterface/GoddardRocket.py` (Vgroups,
`make_units`, a control law closed over the mass), single-phase and as a
three-phase problem with forward links, against the JAX package (CPU, x64,
host loop, jitted calls).

Tolerances: units exact, scales 1e-10, physical objectives 1e-7 relative,
iterations within 1.
"""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

PACKAGES = (jast, tast)
g0 = 32.2
Lstar, Tstar, Mstar = 10000.0, 60.0, 1
Vstar = Lstar / Tstar
h_ref, Tmag, c, sigma = 23800, 200, 1580.94, 5.4915e-5
m0, mf = 3, 1


def goddard_ode(ast):
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class GoddardRocket(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(3, 1)
            h, v, m = XtU.XVec().tolist()
            u = XtU.UVar(0)
            vdot = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) / m \
                - g0
            ode = vf.stack(v, vdot, -u * Tmag / c)
            Vgroups = {("h", "altitude"): h, ("v", "velocity"): v,
                       ("m", "mass"): m, ("t", "time"): XtU.TVar(), "u": u}
            super().__init__(ode, 3, 1, Vgroups=Vgroups)
    return GoddardRocket()


def path_con(ast):
    vf = ast.VectorFunctions
    h, v, m, u = vf.Arguments(4).tolist()
    t1 = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) - g0 * m
    t2 = (m * g0 / (1 + 4 * (c / v) + 2 * (c / v) ** 2)) * (
        c * c * (1 + v / c) / (h_ref * g0) - 1.0 - 2.0 * c / v)
    return t1 - t2


def initial_guess(ast, nsteps=240):
    """Full thrust until the mass is spent, then coast to apogee: the
    integrator with a control law over the Vgroup "m" and a Python
    predicate as stopping event."""
    vf = ast.VectorFunctions
    ode = goddard_ode(ast)
    law = vf.ifelse(vf.Arguments(1)[0] > mf, 1, 0)
    integ = ode.integrator(.01, law, "m")
    X0 = ode.make_input(h=0, v=0, m=m0, u=1)
    return ode, integ.integrate_dense(X0, 60, nsteps, lambda x: x[1] < 0)


@pytest.fixture(scope="module")
def guesses():
    return [initial_guess(ast) for ast in PACKAGES]


def test_vgroups_and_initial_guess(guesses):
    (oj, gj), (ot, gt) = guesses
    assert sorted(ot.Vgroups) == sorted(oj.Vgroups)
    for k in oj.Vgroups:
        assert np.array_equal(ot.Vgroups[k], oj.Vgroups[k])
    assert np.array_equal(ot.make_input(h=1, v=2, m=3, t=4, u=5),
                          oj.make_input(h=1, v=2, m=3, t=4, u=5))
    ot.add_Vgroups({"hv": ["h", "v"], "tail": [2, 3]})
    assert ot.Vgroups["hv"].tolist() == [0, 1]
    assert ot.Vgroups["tail"].tolist() == [2, 3]
    assert len(gt) == len(gj)
    gj, gt = np.stack(gj), np.stack(gt)
    assert np.abs(gt - gj).max() <= 1e-9 * np.abs(gj).max()
    assert abs(gt[-1, 1]) < 1e-6             # stopped at apogee


def single_phase(ast, ode, IG, nsegs, scaling, units=None):
    phase = ode.phase("LGL3", IG, nsegs)
    if scaling:
        phase.setAutoScaling(True)
        phase.setUnits(ode.make_units(h=Lstar, v=Vstar, m=Mstar, t=Tstar)
                       if units is None else units)
    phase.addBoundaryValue("Front", ["h", "v", "m", "t"], IG[0][0:4])
    phase.addLUVarBound("Path", "u", 0.0, 1.0, 1.0)
    phase.addValueObjective("Back", "h", -1.0)
    phase.addBoundaryValue("Back", ["v", "m"], [0, mf])
    phase.optimizer.PrintLevel = 2
    if ast is jast:
        phase.optimizer.UseFused = False
    return phase


def test_set_units_forms(guesses):
    want = np.array([Lstar, Vstar, Mstar, Tstar, 1.0])
    for form in ("array", "positional", "keywords", "short", "mixed"):
        got = []
        for ast, (ode, IG) in zip(PACKAGES, guesses):
            p = ode.phase("LGL3", IG, 6)
            if form == "array":
                p.setUnits(ode.make_units(h=Lstar, v=Vstar, m=Mstar,
                                          t=Tstar))
            elif form == "positional":
                p.setUnits(Lstar, Vstar, Mstar, Tstar, 1.0)
            elif form == "keywords":
                p.setUnits(h=Lstar, velocity=Vstar, m=Mstar, time=Tstar)
            elif form == "short":
                p.setUnits([Lstar, Vstar])
            else:
                p.setUnits([Lstar, Vstar], t=Tstar)
            got.append((p._xtup_units.copy(), p.var_units()))
        (uj, vj), (ut, vt) = got
        assert np.array_equal(ut, uj), form
        assert np.array_equal(vt, vj), form
        if form in ("array", "positional", "keywords"):
            assert np.array_equal(ut, want)
            assert vt.shape == (7 * 4 + 2,) and vt[-1] == Tstar
    p = guesses[1][0].phase("LGL3", guesses[1][1], 6)
    assert np.array_equal(p.var_units(), np.ones(p.numVars))


def test_autoscale_row_and_objective_scales(guesses):
    IG = guesses[0][1]
    pj, pt = (single_phase(ast, ode, IG, 12, True)
              for ast, (ode, _) in zip(PACKAGES, guesses))
    fj, ft = pj._build_families(), pt._build_families()
    assert abs(pt._obj_scale - pj._obj_scale) <= 1e-10 * pj._obj_scale
    assert np.array_equal(pt._scale_vec, pj._scale_vec)
    for kj, kt in zip(fj, ft):
        assert [f.name for f in kt] == [f.name for f in kj]
        for a, b in zip(kt, kj):
            assert (a.napps, a.nin, a.nout) == (b.napps, b.nin, b.nout)
            assert np.array_equal(a.Vidx, b.Vidx)
            assert a.consts.shape == b.consts.shape
            # original consts, then the unit columns, then the row scales
            assert np.abs(a.consts - b.consts).max() <= \
                1e-10 * np.abs(b.consts).max()
            assert getattr(a, "_data_cols", None) == \
                getattr(b, "_data_cols", None)
    # scaled and physical solver inputs
    assert np.allclose(pt.makeSolverInput() * pt._scale_vec,
                       pt.makeSolverInput(raw=True), rtol=1e-15)
    assert np.array_equal(pt.makeSolverInput(), pj.makeSolverInput())
    assert pt._structure_key()[3] is True


@pytest.mark.parametrize("scaling", [False, True],
                         ids=["unscaled", "autoscaled"])
def test_goddard_single_phase(guesses, scaling):
    IG = guesses[0][1]
    pj, pt = (single_phase(ast, ode, IG, 32, scaling)
              for ast, (ode, _) in zip(PACKAGES, guesses))
    fj, ft = pj.optimize(), pt.optimize()
    oj, ot = pj.optimizer, pt.optimizer
    assert ft == fj
    assert abs(ot.LastIterNum - oj.LastIterNum) <= 1
    assert abs(ot.LastObjVal - oj.LastObjVal) <= 1e-7 * abs(oj.LastObjVal)
    hj, ht = pj.returnTraj()[-1][0], pt.returnTraj()[-1][0]
    assert abs(ht - hj) <= 1e-7 * hj
    if scaling:
        # the reported objective is the physical one
        assert abs(ot.LastObjVal + ht) <= 1e-9 * ht
        assert abs(ht - 18728.0) < 60.0


def test_unit_one_autoscaling_keeps_the_objective(guesses):
    """Auto-scaling with unit 1 on every variable scales the rows only:
    the physical objective is the unscaled solve's."""
    ode, IG = guesses[1]
    plain = single_phase(tast, ode, IG, 32, False)
    unit1 = single_phase(tast, ode, IG, 32, True, units=np.ones(5))
    assert plain.optimize() == 0 and unit1.optimize() == 0
    a, b = plain.optimizer.LastObjVal, unit1.optimizer.LastObjVal
    assert abs(a - b) <= 1e-7 * abs(a)


def three_phase(ast, ode, IG, nsegs):
    oc = ast.OptimalControl
    units = ode.make_units(h=Lstar, v=Vstar, m=Mstar, t=Tstar)
    n = int(len(IG) / 3)
    p1 = ode.phase("LGL3", IG[0:n], nsegs)
    p1.addBoundaryValue("Front", ["h", "v", "m", "t"], IG[0][0:4])
    p1.addBoundaryValue("Path", "u", 1.0)
    p2 = ode.phase("LGL3", IG[n:2 * n], nsegs)
    p2.setControlMode("NoSpline")
    p2.addLUVarBound("Path", "u", 0.0, 1.0, 1.0)
    p2.addEqualCon("Path", path_con(ast), ["h", "v", "m", "u"])
    p3 = ode.phase("LGL3", IG[2 * n:-1], nsegs)
    p3.addBoundaryValue("Path", "u", 0)
    p3.addBoundaryValue("Back", ["v", "m"], [0, mf])
    p3.addValueObjective("Back", "h", -1.0)
    ocp = oc.OptimalControlProblem()
    for p in (p1, p2, p3):
        ocp.addPhase(p)
    ocp.addForwardLinkEqualCon(p1, p3, ["h", "v", "m", "t"])
    for p in (p1, p2, p3):
        p.addLowerDeltaTimeBound(0)
        p.setUnits(units)
    ocp.setAutoScaling(True, True)
    ocp.optimizer.PrintLevel = 2
    if ast is jast:
        ocp.optimizer.UseFused = False
    return ocp, (p1, p2, p3)


def test_autoscaled_ocp_with_links(guesses):
    IG = guesses[0][1]
    (oj, pj), (ot, pt) = (three_phase(ast, ode, IG, 10)
                          for ast, (ode, _) in zip(PACKAGES, guesses))
    fj, ft = oj.optimize(), ot.optimize()
    assert np.array_equal(ot._Uglob, oj._Uglob)
    assert ot._Uglob.max() == Lstar
    assert ft == fj == 0
    assert abs(ot.optimizer.LastIterNum - oj.optimizer.LastIterNum) <= 1
    hj, ht = pj[2].returnTraj()[-1][0], pt[2].returnTraj()[-1][0]
    assert abs(ht - hj) <= 1e-7 * hj
    # the links hold in physical values
    for a, b in zip(pt[:-1], pt[1:]):
        assert np.abs(a.returnTraj()[-1][:4] - b.returnTraj()[0][:4]).max() \
            <= 1e-6 * Lstar
