"""Phase parity: the port's transcription of the benchmark CartPole problem
(40 LGL5 segments) against the JAX package's: identical families, gather
indices, constants and initial point, and the defect family's value,
Jacobian and adjoint Hessian to 1e-12 for LGL3/5/7 (reference calls
jitted)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_tpu.Solvers import nlp as jnlp
from asset_asrl_torch.interop import problem_tables_from_numpy
from asset_asrl_torch.Solvers import nlp as tnlp
from chip_smoke import build_cartpole

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


@pytest.fixture(scope="module")
def phases():
    return build_cartpole(jast, 40), build_cartpole(tast, 40)


@pytest.fixture(scope="module")
def families(phases):
    pj, pt = phases
    return pj._build_families(), pt._build_families()


def test_layout_and_initial_point(phases):
    pj, pt = phases
    for a in ("numSegs", "numNodes", "numVars", "_t0i", "_tfi"):
        assert getattr(pj, a) == getattr(pt, a), a
    assert np.array_equal(pj.taus, pt.taus)
    assert np.array_equal(pj.node_of_var(), pt.node_of_var())
    assert np.array_equal(pj.makeSolverInput(), pt.makeSolverInput())


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["eq", "iq", "obj"])
def test_families_identical(families, kind):
    fj, ft = families[0][kind], families[1][kind]
    assert [f.name for f in fj] == [f.name for f in ft]
    for a, b in zip(fj, ft):
        assert (a.napps, a.nin, a.nout) == (b.napps, b.nin, b.nout)
        assert np.array_equal(a.Vidx, b.Vidx)
        assert np.array_equal(a.consts, b.consts)


@pytest.mark.parametrize("tmode", ["LGL3", "LGL5", "LGL7"])
def test_defect_family_derivatives(tmode):
    pj = build_cartpole(jast, 12, tmode)
    pt = build_cartpole(tast, 12, tmode)
    dj, dt = pj._build_families()[0][0], pt._build_families()[0][0]
    assert np.array_equal(dj.Vidx, dt.Vidx)
    assert np.array_equal(dj.consts, dt.consts)
    assert dj.name == dt.name == "defects"
    rng = np.random.default_rng(2)
    x = pj.makeSolverInput()
    noise = 0.05 * rng.normal(size=dj.Vidx.shape)
    xg = x[dj.Vidx] + noise
    lam = rng.normal(size=(dj.napps, dj.nout))
    fj, jj = jax.jit(jnlp._family_valjac(dj.fun))(
        jnp.asarray(xg), jnp.asarray(dj.consts))
    hj = jax.jit(jnlp._family_hess(dj.fun))(
        jnp.asarray(xg), jnp.asarray(dj.consts), jnp.asarray(lam))
    # the JAX family's own gather table and constants, carried across
    vidx, ct = problem_tables_from_numpy(dj.Vidx, dj.consts, device="cpu")
    xt = torch.tensor(x)[vidx] + torch.tensor(noise)
    ft, jt = tnlp._family_valjac(dt.fun)(xt, ct)
    ht = tnlp._family_hess(dt.fun)(xt, ct, torch.tensor(lam))
    for a, b in ((fj, ft), (jj, jt), (hj, ht)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert np.abs(a - b.numpy()).max() <= 1e-12 * max(1.0,
                                                            np.abs(a).max())


def test_value_pass_matches(phases):
    """NonLinearProgram.eval_obj_cons (the line-search pass) on one
    perturbed point."""
    pj, pt = phases
    for p in phases:
        p.optimizer.set_PrintLevel(2)
    nj = jnlp.NonLinearProgram(pj.numVars)
    nt = tnlp.NonLinearProgram(pt.numVars, device="cpu")
    for nlp, (eqs, iqs, objs) in ((nj, pj._build_families()),
                                  (nt, pt._build_families())):
        for f in eqs:
            nlp.addEqualCon(f)
        for f in iqs:
            nlp.addInequalCon(f)
        for f in objs:
            nlp.addObjective(f)
        nlp.freeze()
    x = pj.makeSolverInput() + 0.01 * np.random.default_rng(4).normal(
        size=pj.numVars)
    a = nj.eval_obj_cons(jnp.asarray(x))
    b = nt.eval_obj_cons(torch.tensor(x))
    for u, v in zip(a, b):
        u = np.asarray(u)
        assert np.abs(u - v.numpy()).max() <= 1e-12 * max(1.0,
                                                            np.abs(u).max())
