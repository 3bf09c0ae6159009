"""Integrator parity: the port's adaptive Runge-Kutta integrator
(`asset_asrl_torch/Integrators/rk.py`) against the JAX package's on the
same seeded rows (JAX calls are jitted by its Integrator, x64, CPU).

Tolerances: final rows and dense grids 1e-9 relative, state-transition
matrices 1e-8, second-order sensitivities 1e-6, event times 1e-9; a row
integrated alone and inside a batch gives equal bits.
"""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from chip_smoke import cartpole_ode

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

PACKAGES = (jast, tast)


def two_body(ast):
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class TwoBody(oc.ODEBase):
        def __init__(self):
            a = oc.ODEArguments(6, 0)
            R, V = a.XVec().head3(), a.XVec().tail3()
            super().__init__(vf.stack(V, -1.0 * R.normalized_power3()), 6)
    return TwoBody()


def harmonic(ast):
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class HO(oc.ODEBase):
        def __init__(self):
            a = oc.ODEArguments(2, 0)
            super().__init__(vf.stack(a.XVar(1), -1.0 * a.XVar(0)), 2)
    return HO()


def orbit_rows(n, seed=0):
    """Seeded near-circular two-body rows [r, v, t0]."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 7))
    rows[:, 0] = 1.0 + 0.1 * rng.uniform(-1, 1, n)
    rows[:, 1:3] = 0.05 * rng.normal(size=(n, 2))
    rows[:, 4] = 1.0 + 0.1 * rng.uniform(-1, 1, n)
    rows[:, 3] = 0.1 * rng.normal(size=n)
    rows[:, 5] = 0.1 * rng.normal(size=n)
    return rows


def close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), \
        np.abs(a - b).max()


STEP = {"DOPRI54": 0.1, "DOPRI87": 0.1, "RK4": 0.01}


@pytest.fixture(scope="module")
def integs():
    return {m: [two_body(ast).integrator(m, STEP[m]) for ast in PACKAGES]
            for m in STEP}


@pytest.mark.parametrize("tf", [3.0, -2.0], ids=["forward", "backward"])
@pytest.mark.parametrize("method", list(STEP))
def test_integrate_two_body(integs, method, tf):
    ij, it = integs[method]
    row = orbit_rows(1, seed=1)[0]
    close(it.integrate(row, tf), ij.integrate(row, tf), 1e-9)


@pytest.mark.parametrize("method", list(STEP))
def test_integrate_parallel_two_body(integs, method):
    ij, it = integs[method]
    rows = orbit_rows(8, seed=2)
    tfs = np.array([3.0, 2.5, -2.0, 1.0, -0.5, 2.0, 3.5, -1.5])
    out = it.integrate_parallel(rows, tfs)
    assert isinstance(out, list) and len(out) == 8
    close(np.stack(out), np.stack(ij.integrate_parallel(rows, tfs)), 1e-9)
    assert np.allclose(np.stack(out)[:, 6], tfs, atol=1e-13)


def test_integrate_cartpole_rows():
    ij, it = (cartpole_ode(ast).integrator("DOPRI54", 0.05)
              for ast in PACKAGES)
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.normal(size=(8, 4)), np.zeros((8, 1)),
                           rng.uniform(-2, 2, (8, 1))], axis=1)
    tfs = np.full(8, 1.0)
    close(it.integrate(rows[0], 1.0), ij.integrate(rows[0], 1.0), 1e-9)
    close(np.stack(it.integrate_parallel(rows, tfs)),
          np.stack(ij.integrate_parallel(rows, tfs)), 1e-9)


def test_integrate_dense_grid(integs):
    ij, it = integs["DOPRI54"]
    row = orbit_rows(1, seed=4)[0]
    dj, dt = ij.integrate_dense(row, 2.0, 12), it.integrate_dense(row, 2.0, 12)
    assert len(dt) == 12
    close(np.stack(dt), np.stack(dj), 1e-9)
    # default grid: one point per default step
    assert len(it.integrate_dense(row, 0.5)) == len(
        ij.integrate_dense(row, 0.5))


def test_integrate_dense_parallel(integs):
    """Dense output of a batch: each row on its own grid (here of its own
    length), equal to the JAX package's and bitwise to the row alone."""
    ij, it = integs["DOPRI54"]
    rows = orbit_rows(3, seed=9)
    tfs = [0.35, -0.2, 0.5]
    dj, dt = ij.integrate_dense_parallel(rows, tfs), \
        it.integrate_dense_parallel(rows, tfs)
    assert [len(t) for t in dt] == [len(t) for t in dj] == [4, 3, 6]
    for k, (tj, tt) in enumerate(zip(dj, dt)):
        close(np.stack(tt), np.stack(tj), 1e-9)
        alone = it.integrate_dense(rows[k], tfs[k])
        assert np.array_equal(np.stack(alone), np.stack(tt))


@pytest.mark.parametrize("method", ["DOPRI54", "DOPRI87"])
def test_row_alone_equals_row_in_batch_bitwise(integs, method):
    it = integs[method][1]
    rows = orbit_rows(8, seed=5)
    tfs = np.linspace(1.0, 4.0, 8)
    batch = it.integrate_parallel(rows, tfs)
    for k in (0, 3, 7):
        assert np.array_equal(it.integrate(rows[k], tfs[k]), batch[k])


def test_integrate_stm(integs):
    ij, it = integs["DOPRI54"]
    row = orbit_rows(1, seed=6)[0]
    xj, Jj = ij.integrate_stm(row, 2.0)
    xt, Jt = it.integrate_stm(row, 2.0)
    assert Jt.shape == (7, 7)
    close(xt, xj, 1e-9)
    close(Jt, Jj, 1e-8)
    # the step sizes depend on the state: the time column's tangent flows
    assert np.abs(Jt[:6, 6]).max() > 1e-3


def test_integrate_stm_parallel(integs):
    ij, it = integs["DOPRI54"]
    rows = orbit_rows(4, seed=7)
    tfs = np.array([1.0, 2.0, -1.0, 1.5])
    oj, ot = ij.integrate_stm_parallel(rows, tfs), \
        it.integrate_stm_parallel(rows, tfs)
    assert len(ot) == 4
    for (xj, Jj), (xt, Jt) in zip(oj, ot):
        close(xt, xj, 1e-9)
        close(Jt, Jj, 1e-8)


def test_integrate_stm2(integs):
    ij, it = integs["DOPRI54"]
    row = orbit_rows(1, seed=8)[0]
    xj, Jj, Hj = ij.integrate_stm2(row, 0.6)
    xt, Jt, Ht = it.integrate_stm2(row, 0.6)
    assert Ht.shape == (7, 7, 7)
    close(xt, xj, 1e-9)
    close(Jt, Jj, 1e-8)
    close(Ht, Hj, 1e-6)
    assert np.abs(Ht).max() > 1e-2


def control_case(ast, kind):
    """CartPole integrators whose control is closed through a law."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    ode = cartpole_ode(ast)
    if kind == "law_xt":
        a = vf.Arguments(5)
        law = vf.stack([-2.0 * a[0] - 0.5 * a[2] + vf.sin(a[4])])
        return ode.integrator("DOPRI54", 0.05, law)
    if kind == "law_t":
        a = vf.Arguments(1)
        return ode.integrator("DOPRI54", 0.05, vf.stack([vf.cos(a[0])]))
    if kind == "law_uvars":
        a = vf.Arguments(2)
        return ode.integrator("DOPRI54", 0.05, vf.stack([a[0] * a[1]]),
                              [1, 4])
    ts = np.linspace(0, 1.5, 16)
    traj = [[0.1 * t, 0.2, 0.0, 0.0, t, np.sin(3 * t)] for t in ts]
    tab = oc.LGLInterpTable(ode.vf(), 4, 1, traj)
    return ode.integrator("DOPRI54", 0.05, tab, [5])


@pytest.mark.parametrize("kind", ["law_xt", "law_t", "law_uvars", "table"])
def test_control_law(kind):
    ij, it = (control_case(ast, kind) for ast in PACKAGES)
    row = [0.0, 0.3, 0.1, 0.0, 0.0, 0.7]
    rj, rt = ij.integrate(row, 1.2), it.integrate(row, 1.2)
    close(rt, rj, 1e-9)
    assert rt[5] != 0.7             # the law overwrites the seed control
    close(np.stack(it.integrate_dense(row, 0.4, 4)),
          np.stack(ij.integrate_dense(row, 0.4, 4)), 1e-9)


def test_event_crossings():
    ev = [ast.VectorFunctions.Arguments(3)[0] for ast in PACKAGES]
    out = [harmonic(ast).integrator(.05).integrate_dense(
        [0, 1, 0], 10.0, [(e, 0, 0)]) for ast, e in zip(PACKAGES, ev)]
    (trj, locj), (trt, loct) = out
    hits = [r[2] for r in loct[0]]
    assert len(hits) == 3 == len(locj[0])
    for k, t in enumerate(hits):
        assert abs(t - (k + 1) * np.pi) < 1e-8
        assert abs(t - locj[0][k][2]) < 1e-9
    assert len(trt) == len(trj)
    close(trt[-1], trj[-1], 1e-9)


@pytest.mark.parametrize("direction,tstop", [(-1, np.pi), (1, 2 * np.pi)],
                         ids=["falling", "rising"])
def test_event_stop_directional(direction, tstop):
    out = []
    for ast in PACKAGES:
        ev = ast.VectorFunctions.Arguments(3)[0]
        traj, locs = harmonic(ast).integrator(.05).integrate_dense(
            [0, 1, 0], 10.0, [(ev, direction, 1)])
        out.append(traj[-1])
    assert abs(out[1][2] - tstop) < 1e-8
    assert abs(out[1][2] - out[0][2]) < 1e-9
    close(out[1], out[0], 1e-8)


def test_event_batch():
    out = []
    for ast in PACKAGES:
        ev = ast.VectorFunctions.Arguments(3)[0]
        out.append(harmonic(ast).integrator(.05).integrate_dense_parallel(
            [[0, 1, 0], [0, 2, 0], [0, .5, 0]], [10.0, 10.0, 10.0],
            [(ev, -1, 1)]))
    for (trj, loj), (trt, lot) in zip(*out):
        assert abs(trt[-1][2] - np.pi) < 1e-7
        assert abs(trt[-1][2] - trj[-1][2]) < 1e-9
        assert len(lot[0]) == 1


def test_event_python_callable_stops_on_host():
    """The host path: a bare Python predicate is a stopping event."""
    out = [harmonic(ast).integrator(.05).integrate_dense(
        [0, 1, 0], 10.0, [lambda r: r[0] < 0]) for ast in PACKAGES]
    assert abs(out[1][-1][2] - np.pi) < 1e-8
    assert abs(out[1][-1][2] - out[0][-1][2]) < 1e-9


def test_constructor_overloads_and_setters():
    ode = two_body(tast)
    a = ode.integrator("DOPRI87", 0.2)
    assert (a.method, a.DefStepSize) == ("DOPRI87", 0.2)
    b = tast.Integrators.Integrator(ode, "RK4")
    assert (b.method, b.DefStepSize) == ("RK4", 0.01)
    c = ode.integrator(0.3)
    assert (c.method, c.DefStepSize, c.MinStepSize) == ("DOPRI54", 0.3,
                                                        0.3e-6)
    c.setAbsTol(1e-9)
    c.setRelTol(1e-8)
    c.setStepSizes(0.1, 1e-5, 2.0)
    assert c.AbsTols.tolist() == [1e-9] * 6 and c.MaxStepSize == 2.0
    c.setAbsTols(np.arange(1, 7) * 1e-10)
    assert c.AbsTols[5] == 6e-10
    # a loose tolerance takes fewer steps
    row = orbit_rows(1)[0]
    c.setAbsTol(1e-6)
    c.integrate(row, 3.0)
    tight = ode.integrator(0.1)
    tight.integrate(row, 3.0)
    assert 0 < c.LastStepCount < tight.LastStepCount
