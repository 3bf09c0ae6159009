"""Interpolation tables of the port (`asset_asrl_torch.VectorFunctions.
InterpTable1D`-`4D`) against the JAX package's, on the inputs of
`tests/test_interp_tables.py`: the same accuracy assertions, and values,
Jacobians and adjoint gradients within 1e-12 relative of the JAX
package's (jitted `computeall`), adjoint Hessians within the rounding of
a second difference over the knot intervals the query reads (`hess_tol`),
also at the tables' end knots, where both clamp the query, and inside a
family evaluated with `vmap`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from chip_smoke import family_all

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

PKGS = (jast, tast)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(1.0, np.abs(a).max())


def hess_tol(data, axes, qs):
    """Tolerances of an adjoint Hessian through a table, one for each
    query point of qs (the table's coordinates there): the second
    derivative of a cubic on knots h apart sums terms of size |f| / h^2,
    and a query only reads the knots of its own interval and the two
    beside it, so each package's rounding is about 1e-14 |f| / h^2 with h
    the smallest of those three gaps on any axis (the largest gap
    measured between the two packages here is 1.3e-11, `test_table2d`,
    cubic); never below 1e-12."""
    fmax = max(np.abs(np.asarray(d, float)).max() for d in data)
    out = []
    for q in np.asarray(qs, float).reshape(len(qs), -1):
        h = np.inf
        for a, x in zip(axes, q):
            a = np.asarray(a, float)
            j = np.clip(np.searchsorted(a, np.clip(x, a[0], a[-1]),
                                        side="right") - 1, 0, len(a) - 2)
            h = min(h, np.diff(a)[max(j - 1, 0):j + 2].min())
        out.append(max(1e-12, 1e-14 * fmax / h ** 2))
    return out


def family_pair(jf, tf, x, lam):
    """(JAX, port) values, Jacobians and forward-over-reverse adjoint
    Hessians of a family over the rows of x with multipliers lam: JAX
    vmapped and jitted, the port vmapped (`chip_smoke.family_all`)."""
    def jall(y, l):
        ag = lambda z: jax.vjp(jf.trace, z)[1](l)[0]  # noqa: E731
        return jf.trace(y), jax.jacfwd(jf.trace)(y), jax.jacfwd(ag)(y)
    ref = jax.jit(jax.vmap(jall))(jnp.asarray(x), jnp.asarray(lam))
    got = family_all(tf, tast.config.tensor(x), tast.config.tensor(lam))
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


def same_derivatives(jf, tf, xs, htols, tol=1e-12):
    """Port against JAX: computeall at every point of xs; value, Jacobian
    and adjoint gradient within tol relative, the adjoint Hessian within
    the point's tolerance in htols (`hess_tol`)."""
    L = np.arange(1.0, jf.ORows() + 1.0)
    for x, htol in zip(xs, htols, strict=True):
        got = zip(jf.computeall(x, L), tf.computeall(x, L),
                  (tol, tol, tol, max(tol, htol)))
        for a, b, t in got:
            assert rel(a, b) <= t, (x, a, b)


def _nonuniform(a, b, n, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(a, b, n - 2))
    return np.concatenate([[a], t, [b]])


def port_grad(tab, pts):
    """Gradients of the table's interpolant at every row of pts."""
    g = vmap(grad(lambda c: tab.interp_traced(list(c))[0]))
    return g(tast.config.tensor(np.asarray(pts, float).reshape(
        len(pts), -1))).numpy()


def jax_grad(tab, pts):
    g = jax.jit(jax.vmap(jax.grad(lambda c: tab.interp_traced(
        [c[i] for i in range(tab.ndim)]))))
    return np.asarray(g(jnp.asarray(np.asarray(pts, float).reshape(
        len(pts), -1))))


# --------------------------------------------------------------------- 1D
@pytest.mark.parametrize("kind,tol_v,tol_d", [("linear", 2e-3, 5e-2),
                                              ("cubic", 2e-6, 2e-4)])
@pytest.mark.parametrize("uniform", [True, False])
def test_table1d_value_and_derivative(kind, tol_v, tol_d, uniform):
    if not uniform:
        tol_v, tol_d = tol_v * 5, tol_d * 3   # random knots: larger max gap
    ts = np.linspace(0, 2 * np.pi, 200) if uniform else \
        _nonuniform(0, 2 * np.pi, 300, 1)
    jtab, ttab = (p.VectorFunctions.InterpTable1D(ts, np.sin(ts), kind=kind)
                  for p in PKGS)
    xs = np.linspace(0.3, 5.8, 41)
    vals = np.array([ttab.interp(x) for x in xs])
    assert np.max(np.abs(vals - np.sin(xs))) < tol_v
    assert rel(vals, np.array([jtab.interp(x) for x in xs])) <= 1e-12
    dvals = port_grad(ttab, xs)[:, 0]
    assert np.max(np.abs(dvals - np.cos(xs))) < tol_d
    assert rel(dvals, jax_grad(jtab, xs)[:, 0]) <= 1e-12
    fj, ft = (p.VectorFunctions.Arguments(1)[0] for p in PKGS)
    qs = [[0.3], [2.0], [5.8]]
    same_derivatives(jtab(fj) * 1.5, ttab(ft) * 1.5, qs,
                     hess_tol([np.sin(ts)], [ts], qs))


def test_table1d_linear_exact_on_affine():
    ts = _nonuniform(-1, 3, 17, 2)
    jtab, ttab = (p.VectorFunctions.InterpTable1D(ts, 2.5 * ts - 1.0,
                                                  kind="linear")
                  for p in PKGS)
    for x in np.linspace(-1, 3, 23):
        assert abs(ttab.interp(x) - (2.5 * x - 1.0)) < 1e-12
        assert abs(ttab.interp(x) - jtab.interp(x)) < 1e-12


def test_table1d_vector_valued():
    ts = np.linspace(0, 1, 50)
    vals = np.stack([np.sin(ts), np.cos(ts), ts ** 2], axis=1)
    fj, ft = (p.VectorFunctions.InterpTable1D(ts, vals, kind="cubic")(
        p.VectorFunctions.Arguments(1)[0]) for p in PKGS)
    out = ft.compute(np.array([0.4]))
    assert np.allclose(out, [np.sin(0.4), np.cos(0.4), 0.16], atol=1e-5)
    qs = [[0.4], [0.0], [1.0], [0.77]]
    same_derivatives(fj, ft, qs, hess_tol([vals], [ts], qs))


# --------------------------------------------------------------------- 2D
@pytest.mark.parametrize("kind,tol_v,tol_d", [("linear", 6e-3, 1e-1),
                                              ("cubic", 2e-5, 2e-3)])
def test_table2d(kind, tol_v, tol_d):
    xs = np.linspace(0, np.pi, 80)
    ys = _nonuniform(0, 2.0, 90, 3)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    F = np.sin(X) * np.exp(-Y)
    jtab, ttab = (p.VectorFunctions.InterpTable2D(xs, ys, F, kind=kind)
                  for p in PKGS)
    pts = [(0.7, 0.3), (2.0, 1.5), (1.1, 0.9)]
    gs = port_grad(ttab, pts)
    assert rel(gs, jax_grad(jtab, pts)) <= 1e-12
    for (x, y), g in zip(pts, gs):
        v = ttab.interp(x, y)
        assert abs(v - np.sin(x) * np.exp(-y)) < tol_v
        assert abs(v - jtab.interp(x, y)) <= 1e-12
        gtrue = np.array([np.cos(x) * np.exp(-y), -np.sin(x) * np.exp(-y)])
        assert np.max(np.abs(g - gtrue)) < tol_d
    fj, ft = (p.VectorFunctions.Arguments(2) for p in PKGS)
    pts = [[0.7, 0.4], [2.0, 0.6], [1.1, 1.2]]
    same_derivatives(jtab(fj[0], fj[1] * fj[0]), ttab(ft[0], ft[1] * ft[0]),
                     pts, hess_tol([F], [xs, ys],
                                   [[x, y * x] for x, y in pts]))


# --------------------------------------------------------------------- 3D
def test_table3d_cubic():
    xs = np.linspace(0, 1, 25)
    ys = np.linspace(-1, 1, 30)
    zs = _nonuniform(0, 2, 28, 4)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    F = X ** 2 + np.sin(Y) * Z
    jtab, ttab = (p.VectorFunctions.InterpTable3D(xs, ys, zs, F,
                                                  kind="cubic")
                  for p in PKGS)
    pts = [(0.4, 0.2, 1.1), (0.8, -0.5, 0.3)]
    gs = port_grad(ttab, pts)
    assert rel(gs, jax_grad(jtab, pts)) <= 1e-12
    for (x, y, z), g in zip(pts, gs):
        assert abs(ttab.interp(x, y, z) - (x ** 2 + np.sin(y) * z)) < 5e-4
        gtrue = np.array([2 * x, np.cos(y) * z, np.sin(y)])
        assert np.max(np.abs(g - gtrue)) < 2e-2
    fj, ft = (p.VectorFunctions.Arguments(3) for p in PKGS)
    pts = [[0.4, 0.2, 1.1], [0.8, -0.5, 0.3], [0.0, 1.0, 2.0]]
    same_derivatives(jtab(fj), ttab(ft), pts, hess_tol([F], [xs, ys, zs], pts))


# --------------------------------------------------------------------- 4D
def test_table4d_linear():
    ax = [np.linspace(0, 1, 12) for _ in range(4)]
    G = np.meshgrid(*ax, indexing="ij")
    F = G[0] + 2 * G[1] + 3 * G[2] + 4 * G[3]
    jtab, ttab = (p.VectorFunctions.InterpTable4D(*ax, F, kind="linear")
                  for p in PKGS)
    # linear table is exact on affine data
    pts = [(0.3, 0.6, 0.1, 0.9), (0.55, 0.25, 0.75, 0.4)]
    for pt in pts:
        want = pt[0] + 2 * pt[1] + 3 * pt[2] + 4 * pt[3]
        assert abs(ttab.interp(*pt) - want) < 1e-12
    fj, ft = (p.VectorFunctions.Arguments(4) for p in PKGS)
    same_derivatives(jtab(fj) ** 2, ttab(ft) ** 2, pts, [1e-12] * len(pts))


# --------------------------------------- inside a VectorFunction + FD check
def test_table_in_expression_fd():
    ts = np.linspace(0, 3, 120)
    fns = []
    for p in PKGS:
        tab = p.VectorFunctions.InterpTable1D(ts, np.exp(-ts), kind="cubic")
        X = p.VectorFunctions.Arguments(2)
        fns.append(tab(X[0] * X[1]) * 2.0)
    fn = fns[1]
    x0 = np.array([0.7, 1.3])
    val = fn.compute(x0)[0]
    assert abs(val - 2 * np.exp(-0.91)) < 1e-5
    J = fn.jacobian(x0)
    eps = 1e-6
    for i in range(2):
        xp = x0.copy()
        xp[i] += eps
        xm = x0.copy()
        xm[i] -= eps
        fd = (fn.compute(xp)[0] - fn.compute(xm)[0]) / (2 * eps)
        assert abs(J[0, i] - fd) < 1e-4
    pts = [x0, [1.5, 2.0], [0.1, 0.2]]
    same_derivatives(*fns, pts, hess_tol([np.exp(-ts)], [ts],
                                         [[x * y] for x, y in pts]))


# ------------------------------------------------------ end knots (clamp)
@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_end_knot_derivatives_match_jax(kind):
    """A query exactly on a table's first or last knot: both packages
    clamp it, and the clamp's derivative there is 1/2 in JAX
    (`jnp.clip`); the port must give the same Jacobian and Hessian (a
    `torch.clamp` would double them)."""
    ts = np.linspace(0.0, 2.0, 15)
    ts[1:-1] += np.random.default_rng(5).uniform(-0.03, 0.03, 13)
    ys = np.linspace(-1.0, 1.0, 9)
    X, Y = np.meshgrid(ts, ys, indexing="ij")
    F1, F2 = np.cos(ts) + ts ** 2, np.sin(X) * Y + X * Y ** 2
    fns = []
    for p in PKGS:
        vf = p.VectorFunctions
        t1 = vf.InterpTable1D(ts, F1, kind=kind)
        t2 = vf.InterpTable2D(ts, ys, F2, kind=kind)
        a = vf.Arguments(2)
        fns.append(vf.stack([t1(a[0]) * a[1], t2(a[0], a[1])]))
    pts = [[ts[0], ys[3]], [ts[-1], ys[5]], [ts[0], ys[0]],
           [ts[-1], ys[-1]], [ts[7], ys[4]]]
    same_derivatives(*fns, pts, hess_tol([F1, F2], [ts, ys], pts))
    # the clamp's derivative at the end knot is a half of the slope inside
    J = fns[1].jacobian([ts[-1], 0.5])
    Jin = fns[1].jacobian([ts[-1] - 1e-9, 0.5])
    assert abs(J[0, 0] - 0.5 * Jin[0, 0]) <= 1e-6 * abs(Jin[0, 0])


def test_table_family_under_vmap():
    """A table inside a family: rows evaluated with `vmap` of the value,
    `jacfwd` and the forward-over-reverse adjoint Hessian, against the JAX
    package's vmapped transforms on the same rows."""
    xs = np.linspace(0, 1, 21)
    ys = _nonuniform(0, 2, 17, 6)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    F = np.exp(-X) * np.cos(Y)
    rng = np.random.default_rng(8)
    rows = np.stack([rng.uniform(-0.1, 1.1, 64), rng.uniform(0, 2, 64),
                     rng.normal(size=64)], axis=1)
    rows[:4, :2] = [[0.0, 0.0], [1.0, 2.0], [0.0, 2.0], [1.0, ys[3]]]
    lam = rng.normal(size=(64, 2))
    out = []
    for p in PKGS:
        vf = p.VectorFunctions
        tab = vf.InterpTable2D(xs, ys, F, kind="cubic")
        a = vf.Arguments(3)
        out.append(vf.stack([tab(a[0], a[1]) * a[2],
                             vf.sin(a[2]) + tab(a[1] * 0.5, a[0])]))
    ref, got = family_pair(*out, rows, lam)
    qs = np.concatenate([rows[:, :2], np.stack([0.5 * rows[:, 1],
                                                rows[:, 0]], axis=1)])
    htol = max(hess_tol([F], [xs, ys], qs))
    for a, b, t in zip(ref, got, (1e-12, 1e-12, htol)):
        assert rel(a, b) <= t


def test_first_lookup_inside_a_transform():
    """A table builds its tensors at its first lookup; when that lookup
    runs inside `vjp` (a family's adjoint Hessian), the cached tensors must
    not belong to the transform, or the next call fails ("escaped").  So
    for the `vf` tables and the trajectory table (`LGLInterpTable`)."""
    vf, oc = tast.VectorFunctions, tast.OptimalControl
    ts = np.linspace(0.0, 2.0, 9)
    tab = vf.InterpTable1D(ts, np.sin(ts), kind="cubic")
    rows = [np.array([t, np.cos(t), t * t, t]) for t in ts]
    traj = oc.InterpFunction(oc.LGLInterpTable(3, rows, len(rows)), [0, 1])
    a = vf.Arguments(1)
    for f in (tab(a[0]) * a[0], traj.eval(a[0]).sum() * a[0]):
        first = f.adjointhessian([0.7], [1.0])
        assert np.array_equal(f.adjointhessian([0.7], [1.0]), first)
        assert np.isfinite(f.computeall([1.3], [2.0])[3]).all()
