"""The port's astrodynamics layer (`asset_asrl_torch.Astro`) against the
JAX package's: the 11 tests of `tests/test_astro.py` and
`tests/test_parity.py::test_date_parity` on the port, and on 64 seeded
cases each, all within 1e-10 relative of the JAX package (reference calls
jitted and vmapped): Kepler propagation and its state-transition matrix,
Lambert (single- and multi-revolution), the classical and modified
equinoctial conversions with their Jacobians, J2, and the values,
Jacobians and adjoint Hessians of the nine dynamical models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from test_torch_interp import family_pair

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

A = tast.Astro
JA = jast.Astro
vf = tast.VectorFunctions
RV0 = np.array([1.0, 0.05, -0.02, 0.02, 1.05, 0.15])
N = 64


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(1.0, np.abs(a).max())


def states(n=N, seed=5):
    """Seeded bound two-body states (mu = 1) of eccentricity up to ~0.4."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(n, 3)) * 0.3 + [1.1, 0.0, 0.0]
    v = rng.normal(size=(n, 3)) * 0.15 + [0.0, 0.95, 0.1]
    return np.concatenate([r, v], axis=1)


def elements(n=N, seed=6):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(1.1, 4.0, n), rng.uniform(0.01, 0.8, n),
                     rng.uniform(0.05, 3.0, n),
                     rng.uniform(0.0, 2 * np.pi, n),
                     rng.uniform(0.0, 2 * np.pi, n),
                     rng.uniform(-np.pi, np.pi, n)], axis=1)


def vm(jf, tf, x, order=1, lam=None):
    """(JAX, port) results of a function family over the rows of x:
    values and Jacobians, and with order 2 adjoint Hessians with the rows
    of lam (`family_pair`).  JAX vmapped and jitted, the port vmapped."""
    if order == 2:
        return family_pair(jf, tf, x, lam)
    ref = jax.jit(jax.vmap(lambda y: (jf.trace(y),
                                      jax.jacfwd(jf.trace)(y))))(
        jnp.asarray(x))
    got = vmap(lambda y: (tf.trace(y), jacfwd(tf.trace)(y)))(
        tast.config.tensor(x))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def same(ref, got, tol=1e-10):
    for a, b in zip(ref, got):
        assert rel(a, b) <= tol


# ------------------------------------------------ test_astro.py mirrors
def test_kepler_propagation_vs_integration():
    tb = A.TwoBody(A.Constants.MuEarth, 7000e3)
    integ = tb.integrator(0.01)
    integ.setAbsTol(1e-13)
    for T in [0.5, 3.0, 7.0]:
        rv1 = A.propagate_kepler(RV0, T)
        rv2 = integ.integrate(np.concatenate([RV0, [0.0]]), T)
        assert np.abs(rv1 - rv2[:6]).max() < 1e-10


def test_kepler_propagator_stm():
    kp = A.KeplerPropagator(1.0)
    X = np.concatenate([RV0, [2.5]])
    J = kp.jacobian(X)
    h = 1e-7
    for i in range(7):
        Xp = X.copy(); Xp[i] += h
        Xm = X.copy(); Xm[i] -= h
        col = (kp.compute(Xp) - kp.compute(Xm)) / (2 * h)
        assert np.abs(J[:, i] - col).max() < 1e-6
    # STM of a Hamiltonian flow is symplectic: det = 1
    assert abs(np.linalg.det(J[:6, :6]) - 1.0) < 1e-8


def test_lambert_roundtrip():
    for T in [0.8, 2.0, 4.5]:
        rvB = A.propagate_kepler(RV0, T)
        v1, v2 = A.lambert_izzo(RV0[:3], rvB[:3], T)
        assert np.abs(v1 - RV0[3:]).max() < 1e-9
        assert np.abs(v2 - rvB[3:]).max() < 1e-9


def test_element_conversions():
    rng = np.random.default_rng(3)
    for _ in range(10):
        rv = np.concatenate([rng.normal(size=3) * 0.5 + [1.2, 0, 0],
                             rng.normal(size=3) * 0.3 + [0, 1.0, 0]])
        oe = A.cartesian_to_classic(rv)
        assert np.abs(A.classic_to_cartesian(oe) - rv).max() < 1e-10
        mee = A.cartesian_to_modified(rv)
        assert np.abs(A.modified_to_cartesian(mee) - rv).max() < 1e-10


def test_mee_dynamics_consistency():
    """MEE ballistic propagation must match cartesian two-body."""
    m = A.MEETwoBody_LT(A.Constants.MuEarth, 7000e3)
    mee0 = A.cartesian_to_modified(RV0)
    row = np.concatenate([mee0, [0.0], [0, 0, 0]])   # zero throttle
    integ = m.integrator(0.01)
    integ.setAbsTol(1e-13)
    out = integ.integrate(row, 2.0)
    rv_mee = A.modified_to_cartesian(out[:6])
    rv_cart = A.propagate_kepler(RV0, 2.0)
    assert np.abs(rv_mee - rv_cart).max() < 1e-9


def test_cr3bp_jacobi_conservation():
    cr = A.CR3BP(A.Constants.MuEarth, A.Constants.MuMoon, A.Constants.LD)
    x0 = np.concatenate([cr.L4 + [0.01, 0.0, 0.0], [0, 0.01, 0], [0.0]])
    integ = cr.integrator(0.01)
    integ.setAbsTol(1e-13)
    traj = integ.integrate_dense(x0, 5.0, 50)
    c0 = cr.JacobiConstant(traj[0])
    cf = cr.JacobiConstant(traj[-1])
    assert isinstance(c0, float) or np.ndim(c0) == 0
    assert abs(cf - c0) < 1e-10


def test_twobody_lt_thrust():
    lt = A.TwoBody_LT(A.Constants.MuEarth, 7000e3,
                      A.LowThrustAcc(NonDim_LTacc=0.05))
    row = np.concatenate([RV0, [0.0], [0, 1, 0]])
    f = lt.vf().compute(row)
    f0 = A.TwoBody(A.Constants.MuEarth, 7000e3).vf().compute(
        np.concatenate([RV0, [0.0]]))
    assert np.allclose(f - f0, [0, 0, 0, 0, 0.05, 0])


def test_element_conversion_roundtrip_and_jacobian():
    oe = np.array([1.3, 0.23, 0.4, 1.1, 0.7, 0.9])
    rv = A.classic_to_cartesian(oe, mu=1.0)
    assert np.allclose(A.CartesianToClassic(1.0).compute(rv), oe, atol=1e-10)
    c2m = A.CartesianToModified(1.0)
    mee = c2m.compute(rv)
    assert np.allclose(A.ModifiedToCartesian(1.0).compute(mee), rv,
                       atol=1e-10)
    J = c2m.jacobian(rv)
    eps = 1e-7
    for i in range(6):
        xp, xm = rv.copy(), rv.copy()
        xp[i] += eps
        xm[i] -= eps
        fd = (c2m.compute(xp) - c2m.compute(xm)) / (2 * eps)
        assert np.max(np.abs(J[:, i] - fd)) < 1e-5, i


def test_lambert_batch_matches_scalar_and_dynamics():
    rng = np.random.default_rng(3)
    r1s, r2s, tofs = [], [], []
    for _ in range(6):
        r1 = np.array([1.0, 0, 0]) + rng.normal(size=3) * 0.05
        ang = 1.0 + rng.uniform(0, 1.5)
        r2 = 1.2 * np.array([np.cos(ang), np.sin(ang), 0.1 * rng.normal()])
        r1s.append(r1)
        r2s.append(r2)
        tofs.append(1.5 + rng.uniform(0, 2.0))
    V1, V2 = A.lambert_izzo_batch(r1s, r2s, tofs)
    pairs = A.lambert_izzo_multi(r1s, r2s, tofs)
    for i in range(6):
        v1, v2 = A.lambert_izzo(r1s[i], r2s[i], tofs[i])
        assert np.allclose(V1[i], v1, atol=1e-12)
        assert np.array_equal(pairs[i][0], V1[i])
        out = A.propagate_kepler(np.concatenate([r1s[i], V1[i]]), tofs[i])
        assert np.allclose(out[:3], r2s[i], atol=1e-8), (i, out[:3] - r2s[i])
        assert np.allclose(out[3:], V2[i], atol=1e-8)


def test_rootfinder_node():
    X = vf.Arguments(3)    # [E_guess, e, M]
    rf = vf.ScalarRootFinder(X[0] - X[1] * vf.sin(X[0]) - X[2])
    e, M = 0.3, 1.1
    inp = np.array([M, e, M])
    E = float(rf.compute(inp)[0])
    assert abs(E - e * np.sin(E) - M) < 1e-11
    J = rf.jacobian(inp)
    assert abs(J[0, 2] - 1.0 / (1.0 - e * np.cos(E))) < 1e-9
    assert abs(J[0, 0]) < 1e-9


def test_j2_cartesian():
    mu, J2, Rb = 1.0, 1.0e-3, 1.0
    fn = A.J2Cartesian(mu, J2, Rb)
    r = np.array([0.9, 0.3, 0.5])
    a = fn.compute(np.concatenate([r, [0.0, 0.0, 1.0]]))
    rn = np.linalg.norm(r)
    z = r[2]
    pref = 1.5 * J2 * mu * Rb ** 2 / rn ** 4
    want = pref * np.array([
        r[0] / rn * (5 * z ** 2 / rn ** 2 - 1),
        r[1] / rn * (5 * z ** 2 / rn ** 2 - 1),
        r[2] / rn * (5 * z ** 2 / rn ** 2 - 3)])
    assert np.allclose(a, want, rtol=1e-12), (a, want)


def test_date_parity():
    from asset_asrl_torch.Astro import Date
    assert Date.date_to_jd(2000, 1, 1, 12) == 2451545.0
    assert Date.jd_to_mjd(Date.mjd_to_jd(51544.5)) == 51544.5
    y, m, d = Date.jd_to_date(2451545.0)
    assert (y, m) == (2000, 1) and abs(d - 1.5) < 1e-9
    y, m, d, hh, mm, ss = Date.jd_to_date2(2451545.0)
    assert (y, m, d, hh) == (2000, 1, 1, 12)
    frac = Date.hmsm_to_days(13, 45, 30, 250000)
    assert Date.days_to_hmsm(frac) == (13, 45, 30, 250000)
    dt = Date.datetime(2025, 3, 14, 15, 9, 26)
    assert abs(Date.jd_to_datetime(dt.to_jd()).to_jd() - dt.to_jd()) < 1e-9
    assert Date.Date_SPJ2000(1, 1, 2000) == -43200.0
    assert Date.JD_SPJ2000D(2451546.0) == 1.0
    assert abs(Date.date_to_jd(333, 1, 27.5) - 1842713.0) < 1e-9
    for jd in (2451545.0, 2459000.5, 1842713.0):
        assert Date.jd_to_date2(jd) == JA.Date.jd_to_date2(jd)
    for k, a in vars(JA.Constants).items():
        if isinstance(a, (int, float)) and not k.startswith("_"):
            assert getattr(A.Constants, k) == a, k


# ------------------------------------------------- 64 cases against JAX
def test_propagation_and_stm_match_jax():
    X = states()
    dts = np.random.default_rng(7).uniform(-4.0, 9.0, N)
    assert rel(JA.propagate_kepler(X, dts), A.propagate_kepler(X, dts)) \
        <= 1e-10
    assert rel(JA.propagate_kepler(X[3], 2.5), A.propagate_kepler(X[3], 2.5)) \
        <= 1e-10
    ref, got = vm(JA.KeplerPropagator(1.0), A.KeplerPropagator(1.0),
                  np.concatenate([X, dts[:, None]], axis=1))
    same(ref, got)


@pytest.mark.parametrize("nrevs,right", [(0, False), (1, False), (1, True)])
def test_lambert_matches_jax(nrevs, right):
    """64 seeded transfers between the two ends of propagated arcs (more
    than one period long for Nrevs = 1).  Every lane whose solution
    satisfies the dynamics (propagating (r1, v1) by tof lands on r2 to
    1e-8) agrees with the JAX package to 1e-10; the multi-revolution
    branch a lane asks for need not exist, and a lane without a solution
    (40 clipped Newton steps from no root) is rounding-chaotic in both
    packages, so it is held only to being finite."""
    rng = np.random.default_rng(8 + nrevs + right)
    X = states(seed=9)
    dts = rng.uniform(0.5, 4.0, N) + (10.0 if nrevs else 0.0)
    r2 = A.propagate_kepler(X, dts)[:, :3]
    ref = JA.lambert_izzo_batch(X[:, :3], r2, dts, Nrevs=nrevs,
                                rightbranch=right)
    got = A.lambert_izzo_batch(X[:, :3], r2, dts, Nrevs=nrevs,
                               rightbranch=right)
    land = A.propagate_kepler(np.concatenate([X[:, :3], got[0]], 1), dts)
    ok = (np.abs(land[:, :3] - r2).max(1) < 1e-8) \
        & (np.abs(land[:, 3:] - got[1]).max(1) < 1e-8)
    assert ok.sum() >= (N - 2 if nrevs == 0 else N // 2)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
    same([ref[0][ok], ref[1][ok]], [got[0][ok], got[1][ok]])
    i = int(np.argmax(ok))
    one = A.lambert_izzo(X[i, :3], r2[i], dts[i], Nrevs=nrevs,
                         rightbranch=right)
    same([ref[0][i], ref[1][i]], one)


def test_porkchop_lanes_are_two_body_arcs():
    """A 24 x 24 corner of `chip_smoke.py`'s Earth to Mars porkchop grid:
    every lane's Lambert solution, the port's and the JAX package's, is a
    two-body arc by Kepler's equation and the conserved quantities
    (`conic_residuals`, no propagator or Lambert solver), and the two
    agree to 1e-10."""
    from chip_smoke import conic_residuals, porkchop
    r1, r2, tof = porkchop(24, 24)
    ref = JA.lambert_izzo_batch(r1, r2, tof)
    got = A.lambert_izzo_batch(r1, r2, tof)
    for v1, v2 in (ref, got):
        assert conic_residuals(r1, v1, r2, v2, tof).max() <= 1e-10
    same(ref, got)


def test_conversions_match_jax():
    X, OE = states(), elements()
    for name, x in (("CartesianToClassic", X), ("CartesianToModified", X),
                    ("ClassicToCartesian", OE), ("ClassicToModified", OE)):
        ref, got = vm(getattr(JA, name)(1.0), getattr(A, name)(1.0), x)
        same(ref, got)
    MEE = np.array([JA.cartesian_to_modified(x) for x in X])
    for name in ("ModifiedToCartesian", "ModifiedToClassic"):
        ref, got = vm(getattr(JA, name)(1.0), getattr(A, name)(1.0), MEE)
        same(ref, got)
    for fn, x in (("cartesian_to_classic", X[0]), ("classic_to_cartesian",
                                                   OE[0]),
                  ("cartesian_to_modified", X[1]),
                  ("modified_to_cartesian", MEE[2])):
        assert rel(getattr(JA, fn)(x, 2.0), getattr(A, fn)(x, 2.0)) <= 1e-10


def test_j2_matches_jax():
    X = states()
    pole = np.random.default_rng(10).normal(size=(N, 3))
    ref, got = vm(JA.J2Cartesian(1.0, 1.08e-3, 0.2),
                  A.J2Cartesian(1.0, 1.08e-3, 0.2),
                  np.concatenate([X[:, :3], pole], axis=1))
    same(ref, got)
    MEE = np.array([JA.cartesian_to_modified(x) for x in X])
    ref, got = vm(JA.J2Modified(1.0, 1.08e-3, 0.2, pole=(0.1, 0.2, 1.0)),
                  A.J2Modified(1.0, 1.08e-3, 0.2, pole=(0.1, 0.2, 1.0)),
                  MEE)
    same(ref, got)


def models(P):
    """The nine dynamical models of `Astro.AstroModels`, built from
    package P's namespace, with the state columns they take."""
    c = P.Astro.Constants
    csi = P.Astro.CSIThruster(.32, 3000, 4000)
    sail = P.Astro.SolarSail(0.03, True)
    return {
        "TwoBody": P.Astro.TwoBody(c.MuEarth, 7000e3),
        "Kepler": P.Astro.Kepler(c.MuSun, c.AU),
        "CR3BP": P.Astro.CR3BP(c.MuEarth, c.MuMoon, c.LD),
        "TwoBody_LT": P.Astro.TwoBody_LT(c.MuEarth, 7000e3,
                                         P.Astro.LowThrustAcc(0.05)),
        "CR3BP_LT": P.Astro.CR3BP_LT(c.MuEarth, c.MuMoon, c.LD),
        "MEETwoBody_LT": P.Astro.MEETwoBody_LT(c.MuSun, c.AU),
        "MEETwoBody_CSI": P.Astro.MEETwoBody_CSI(c.MuSun, c.AU, csi),
        "TwoBody_SolarSail": P.Astro.TwoBody_SolarSail(SailModel=sail),
        "CR3BP_SolarSail": P.Astro.CR3BP_SolarSail(SailModel=sail),
    }


@pytest.mark.parametrize("name", ["TwoBody", "Kepler", "CR3BP",
                                  "TwoBody_LT", "CR3BP_LT", "MEETwoBody_LT",
                                  "MEETwoBody_CSI", "TwoBody_SolarSail",
                                  "CR3BP_SolarSail"])
def test_model_eoms_match_jax(name):
    jm, tm = models(jast)[name], models(tast)[name]
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    n = tm.vf().IRows()
    X = states()
    rows = np.zeros((N, n))
    if name.startswith("MEE"):
        rows[:, :6] = np.array([JA.cartesian_to_modified(x) for x in X])
    else:
        rows[:, :6] = X * (0.6 if "CR3BP" in name else 1.0)
    if name == "MEETwoBody_CSI":
        rows[:, 6] = rng.uniform(0.5, 1.0, N)
    xv = tm.XVars()
    rows[:, xv] = rng.uniform(0, 3, N)             # time
    rows[:, xv + 1:] = rng.normal(size=(N, n - xv - 1)) * 0.5
    lam = rng.normal(size=(N, tm.vf().ORows()))
    ref, got = vm(jm.vf(), tm.vf(), rows, order=2, lam=lam)
    same(ref, got)
    assert (tm.XVars(), tm.UVars()) == (jm.XVars(), jm.UVars())


def test_frames_constraints_and_lissajous_match_jax():
    jc, tc = (models(P)["CR3BP"] for P in (jast, tast))
    for k in ("L1", "L2", "L3", "L4", "L5"):
        assert rel(getattr(jc, k), getattr(tc, k)) <= 1e-12
    st = np.array([0.8, 0.1, 0.02, 0.01, 0.2, 0.03])
    j = tc.JacobiConstant(st)
    assert isinstance(j, (float, np.floating)) and abs(
        j - jc.JacobiConstant(st)) <= 1e-12 * abs(j)
    a = jc.GenL2Lissajous(0.01, 0.02, 10.0, 20.0, 2, 9)
    b = tc.GenL2Lissajous(0.01, 0.02, 10.0, 20.0, 2, 9)
    assert all(isinstance(r, np.ndarray) for r in b)
    assert rel(np.array(a), np.array(b)) <= 1e-10
    X = states(8)
    for name, args in (("RadiusLowerBound", (0.5,)),
                       ("RadiusBound", (0.5, 2.0)), ("SpeedBound", (1.5,)),
                       ("PeriapsisRadius", (1.0, 0.7)),
                       ("ApoapsisRadius", (1.0, 1.9)),
                       ("FlightPathAngle", (0.1,)),
                       ("CircularOrbit", (1.0, 1.2))):
        jf = getattr(JA.AstroConstraints, name)(*args)
        tf = getattr(A.AstroConstraints, name)(*args)
        x = X[:, :tf.IRows()]
        ref, got = vm(jf, tf, x, order=2,
                      lam=np.ones((len(x), tf.ORows())))
        same(ref, got)
