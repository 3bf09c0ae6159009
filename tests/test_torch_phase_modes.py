"""Phase transcriptions, control modes and the constraint/objective API:
the port's families against the JAX package's (names, gather tables,
constants, and value + Jacobian at a perturbed initial guess through the
jitted `_family_valjac`), the PSIOPT schedules against the JAX host loop,
and the single-phase breadth problems solved against the JAX package's
flags, iterations and objectives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_tpu.Solvers import nlp as jnlp
from asset_asrl_torch.Solvers import nlp as tnlp
from chip_smoke import (BRACH_24, CARTPOLE_128, build_brachistochrone,
                        build_cartpole)

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

CONVERGED = 0
TOL = 1e-12


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(
        1.0, np.abs(a).max(initial=0.0))


def compare_family(fj, ft, x, seed):
    """Identical layout, and value + Jacobian equal at x (+ noise)."""
    assert fj.name == ft.name
    assert (fj.napps, fj.nin, fj.nout) == (ft.napps, ft.nin, ft.nout)
    assert np.array_equal(fj.Vidx, ft.Vidx)
    assert np.array_equal(fj.consts, ft.consts[:, :fj.consts.shape[1]])
    rng = np.random.default_rng(seed)
    xg = x[fj.Vidx] + 0.01 * rng.normal(size=fj.Vidx.shape)
    vj, jj = jax.jit(jnlp._family_valjac(fj.fun))(jnp.asarray(xg),
                                                   jnp.asarray(fj.consts))
    vt, jt = tnlp._family_valjac(ft.fun)(torch.tensor(xg),
                                         torch.tensor(ft.consts))
    close(vj, vt)
    close(jj, jt)


def families(phase):
    eqs, iqs, objs = phase._build_families()
    return eqs + iqs + objs


# ------------------------------------------------- transcription x control
MODES = [("LGL3", None), ("LGL3", "BlockConstant"),
         ("LGL5", "BlockConstant"), ("LGL5", "HighestOrderSpline"),
         ("LGL5", "NoSpline"), ("LGL7", "HighestOrderSpline"),
         ("LGL7", "BlockConstant"), ("Trapezoidal", None),
         ("CentralShooting", None)]


@pytest.mark.parametrize("tmode,cmode", MODES)
def test_modes_families_match(tmode, cmode):
    pj = build_cartpole(jast, 6, tmode, cmode)
    pt = build_cartpole(tast, 6, tmode, cmode)
    assert np.array_equal(pj.node_of_var(), pt.node_of_var())
    x = pj.makeSolverInput()
    assert np.array_equal(x, pt.makeSolverInput())
    fj, ft = families(pj), families(pt)
    assert [f.name for f in fj] == [f.name for f in ft]
    for i, (a, b) in enumerate(zip(fj, ft)):
        compare_family(a, b, x, seed=i)


# ------------------------------------------------------ constraint forms
def _param_phase(ast):
    """A double integrator with one ODE parameter (control gain) and two
    static parameters, 5 LGL5 segments."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class ODE(oc.ODEBase):
        def __init__(self):
            XtUP = oc.ODEArguments(2, 1, 1)
            super().__init__(vf.stack([XtUP.XVar(1),
                                       XtUP.UVar(0) * XtUP.PVar(0)]),
                             2, 1, 1)

    ts = np.linspace(0, 2, 12)
    IG = [[0.5 * t, 0.5 + 0.1 * t, t, 0.3 - 0.2 * t, 1.2] for t in ts]
    ph = ODE().phase("LGL5", IG, 5)
    ph.setStaticParams([0.3, 0.7])
    ph.addBoundaryValue("Front", [0, 1, 2], [0, 0.5, 0])
    return ph


def _forms():
    """name -> adder(phase, vf): each adds one constraint/objective."""
    def A(vf, n):
        return vf.Arguments(n)
    return {
        "eq_full": lambda p, vf: p.addEqualCon(
            "Path", A(vf, 4)[0] * A(vf, 4)[3] - A(vf, 4)[2]),
        "eq_full_params": lambda p, vf: p.addEqualCon(
            "Back", A(vf, 7)[0] * A(vf, 7)[4] + A(vf, 7)[5] - A(vf, 7)[6]),
        "eq_subset": lambda p, vf: p.addEqualCon(
            "Back", A(vf, 4).head2() * A(vf, 4)[2] - A(vf, 4)[3],
            [0, 1], [0], [1]),
        "iq_pairwise": lambda p, vf: p.addInequalCon(
            "PairWisePath", (A(vf, 8)[3] - A(vf, 8)[7]) ** 2 - 1.0),
        "iq_innerpath": lambda p, vf: p.addInequalCon(
            "InnerPath", vf.sin(A(vf, 4)[0]) - A(vf, 4)[1]),
        "eq_backandfront": lambda p, vf: p.addEqualCon(
            "BackandFront", A(vf, 8)[1] - A(vf, 8)[5] * A(vf, 8)[4]),
        "eq_frontandback": lambda p, vf: p.addEqualCon(
            "FrontandBack", A(vf, 8)[0] * A(vf, 8)[4] - 1.0),
        "eq_odeparams": lambda p, vf: p.addEqualCon(
            "ODEParams", A(vf, 1) ** 2 - 1.0),
        "eq_staticparams": lambda p, vf: p.addEqualCon(
            "StaticParams", A(vf, 2)[0] * A(vf, 2)[1] - 0.2),
        "boundary": lambda p, vf: p.addBoundaryValue("Back", [0, 1],
                                                     [1.0, 0.0]),
        "valuelock": lambda p, vf: p.addValueLock("Back", [0]),
        "valuelock_static": lambda p, vf: p.addValueLock("StaticParams",
                                                         [1]),
        "valuelock_ode": lambda p, vf: p.addValueLock("ODEParams", [0]),
        "periodicity": lambda p, vf: p.addPeriodicityCon([1]),
        "luvar": lambda p, vf: p.addLUVarBound("Path", 3, -1.0, 1.0, 2.0),
        "luvar_list": lambda p, vf: p.addLUVarBound("Path", [0, 3], -3.0,
                                                    3.0),
        "lowervar": lambda p, vf: p.addLowerVarBound("Path", 1, -2.0),
        "uppervar": lambda p, vf: p.addUpperVarBound("Back", 2, 5.0, 0.5),
        "lufunc": lambda p, vf: p.addLUFuncBound(
            "Path", A(vf, 2)[0] * A(vf, 2)[1], [0, 3], -1.0, 1.0),
        "lowerfunc": lambda p, vf: p.addLowerFuncBound(
            "Path", vf.exp(A(vf, 2)[0]) - A(vf, 2)[1], [1, 3], -4.0, 2.0),
        "upperfunc": lambda p, vf: p.addUpperFuncBound(
            "InnerPath", A(vf, 1)[0] ** 2, [3], 4.0),
        "lunorm": lambda p, vf: p.addLUNormBound("Path", [0, 1], 0.01, 5.0),
        "lowernorm": lambda p, vf: p.addLowerNormBound("Path", [0, 1],
                                                       0.01),
        "uppernorm": lambda p, vf: p.addUpperNormBound("Path", [1, 3], 5.0),
        "lusqnorm": lambda p, vf: p.addLUSquaredNormBound(
            "Path", [0, 3], 0.0, 9.0, 3.0),
        "upperdt": lambda p, vf: p.addUpperDeltaTimeBound(5.0),
        "lowerdt": lambda p, vf: p.addLowerDeltaTimeBound(0.5, 2.0),
        "deltavareq": lambda p, vf: p.addDeltaVarEqualCon(0, 1.0),
        "deltatimeeq": lambda p, vf: p.addDeltaTimeEqualCon(2.0),
        "valueobj": lambda p, vf: p.addValueObjective("Back", 0, 2.0),
        "stateobj": lambda p, vf: p.addStateObjective(
            "Back", A(vf, 4)[0] ** 2 + A(vf, 4)[3]),
        "stateobj_subset": lambda p, vf: p.addStateObjective(
            "Front", A(vf, 2)[0] * A(vf, 2)[1], [1], [0]),
        "deltavarobj": lambda p, vf: p.addDeltaVarObjective(1, 3.0),
        "deltatimeobj": lambda p, vf: p.addDeltaTimeObjective(1.0),
        "intobj": lambda p, vf: p.addIntegralObjective(
            A(vf, 2)[0] * A(vf, 2)[1] ** 2, [0, 3]),
        "intparam": lambda p, vf: p.addIntegralParamFunction(
            A(vf, 1)[0] ** 2, [3], 1),
    }


FORMS = _forms()


@pytest.mark.parametrize("form", sorted(FORMS))
def test_constraint_form_matches(form):
    phases = []
    for ast in (jast, tast):
        p = _param_phase(ast)
        FORMS[form](p, ast.VectorFunctions)
        phases.append(p)
    pj, pt = phases
    x = pj.makeSolverInput()
    assert np.array_equal(x, pt.makeSolverInput())
    fj, ft = families(pj), families(pt)
    assert [f.name for f in fj] == [f.name for f in ft]
    spec_j, spec_t = pj._specs[-1], pt._specs[-1]
    new_j = [f for f, s in pj._built if s is spec_j]
    new_t = [f for f, s in pt._built if s is spec_t]
    assert len(new_j) == len(new_t) == 1
    compare_family(new_j[0], new_t[0], x, seed=len(form))


def test_subvariables_moves_lock_data():
    """subVariables changes a lock's target in the live consts (no
    re-transcription), identically in both packages."""
    out = []
    for ast in (jast, tast):
        p = _param_phase(ast)
        p.addValueLock("Back", [0])
        p.addValueLock("StaticParams", [1])
        p.optimizer.set_PrintLevel(2)
        p.transcribe()
        nlp = p._nlp
        p.subVariables("Back", [0], [0.75])
        p.subVariable("StaticParams", 1, 0.4)
        assert p._nlp is nlp
        x = p.makeSolverInput()
        assert x[p._spi(1)] == 0.4
        _, cE, _ = nlp.eval_obj_cons(
            jnp.asarray(x) if ast is jast else torch.tensor(x))
        out.append(np.asarray(cE))
    close(out[0], out[1])


def test_remove_forms():
    for ast in (jast, tast):
        vf = ast.VectorFunctions
        p = _param_phase(ast)
        p.addStateObjective("Back", vf.Arguments(4)[0] ** 2)
        p.addIntegralObjective(vf.Arguments(1)[0] ** 2, [3])
        p.addEqualCon("Back", vf.Arguments(4)[1] - 1.0)
        p.removeStateObjective()
        p.removeIntegralObjective(-1)
        p.removeEqualCon()
        kinds = [s.kind for s in p._specs]
        assert kinds == ["eq"] and p._specs[0].name == "boundary"


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("method", ["solve", "solve_optimize",
                                    "solve_optimize_solve",
                                    "optimize_solve"])
def test_schedules_match_jax_host_loop(method):
    """Each PSIOPT schedule on the Brachistochrone (LGL3, 8 segments), then
    a warm-started optimize: flag, iterations (counted over all passes)
    and objective equal to the JAX package's host loop."""
    res = []
    for ast in (jast, tast):
        p = build_brachistochrone(ast, "LGL3", 8)
        p.optimizer.set_PrintLevel(2)
        p.optimizer.UseFused = False
        flag = getattr(p, method)()
        first = (flag, p.optimizer.LastIterNum, p.optimizer.LastObjVal)
        p.optimizer.WarmStart = True
        flag = p.optimize()
        res.append((first, (flag, p.optimizer.LastIterNum,
                            p.optimizer.LastObjVal)))
    for (fj, ij, oj), (ft, it, ot) in zip(*res):
        assert (fj, ij) == (ft, it)
        assert abs(oj - ot) <= 1e-9 * max(1.0, abs(oj))


# --------------------------------------------------------------- breadth
@pytest.mark.parametrize("tmode", sorted(BRACH_24))
def test_brachistochrone_transcriptions(tmode):
    flag0, it0, obj0 = BRACH_24[tmode]
    p = build_brachistochrone(tast, tmode, 24)
    p.optimizer.set_PrintLevel(2)
    p.optimizer.UseFused = False        # BRACH_24: the JAX host loop
    assert p.optimize() == flag0 == CONVERGED
    assert p.optimizer.LastIterNum == it0
    assert abs(p.optimizer.LastObjVal - obj0) <= 1e-7 * obj0


@pytest.mark.parametrize("cmode,kwb", [("BlockConstant", (129, 24, 2)),
                                       ("HighestOrderSpline", (65, 42, 2))])
def test_cartpole_control_modes(cmode, kwb):
    flag0, it0, obj0 = CARTPOLE_128[cmode]
    p = build_cartpole(tast, 128, "LGL5", cmode)
    p.optimizer.set_PrintLevel(2)
    p.optimizer.UseFused = False        # CARTPOLE_128: the JAX host loop
    assert p.optimize() == flag0 == CONVERGED
    bs = p.optimizer.kkt.bs
    assert (bs.K, bs.W, bs.b) == kwb
    assert p.optimizer.LastIterNum == it0
    assert abs(p.optimizer.LastObjVal - obj0) <= 1e-7 * obj0
