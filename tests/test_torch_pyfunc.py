"""Python-callback functions of the port (`asset_asrl_torch.
VectorFunctions.PyVectorFunction`, `PyScalarFunction`) and
`FDDerivChecker` against the JAX package's: the host methods and
`computeall` equal to 1e-12; inside an expression and under `vmap` the
callback's Jacobian is the FD Jacobian (1e-10 of JAX); a second
derivative through the callback raises, as in JAX; and the
`tests/test_vectorfunctions.py` use of PyVectorFunction as an FD checker
of port expressions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vjp, vmap

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_torch.VectorFunctions.Extensions.DerivChecker import \
    FDDerivChecker

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


def callback(x, scale=1.0):
    """A numpy function R^3 -> R^2, and the number of its calls."""
    callback.calls += 1
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    return scale * np.array([x[0] * np.sin(x[1]) + x[2] ** 2,
                             np.exp(0.3 * x[0]) * x[1] - x[2]])


callback.calls = 0


def both(**kw):
    return [p.VectorFunctions.PyVectorFunction(3, 2, callback, args=(1.5,),
                                               **kw) for p in (jast, tast)]


def test_host_methods_equal_jax():
    X = np.array([0.4, -1.1, 0.7])
    L = np.array([0.5, -2.0])
    for kw in ({}, {"jstepsize": 1e-5, "hstepsize": 1e-4}):
        jf, tf = both(**kw)
        for name in ("compute", "jacobian"):
            a, b = getattr(jf, name)(X), getattr(tf, name)(X)
            assert np.abs(a - b).max() <= 1e-12 * max(1, np.abs(a).max())
        for name in ("adjointgradient", "adjointhessian"):
            a, b = getattr(jf, name)(X, L), getattr(tf, name)(X, L)
            assert np.abs(a - b).max() <= 1e-12 * max(1, np.abs(a).max())
        for a, b in zip(jf.computeall(X, L), tf.computeall(X, L)):
            assert np.abs(a - b).max() <= 1e-12 * max(1, np.abs(a).max())
    s = tast.VectorFunctions.PyScalarFunction(3, lambda x: [x @ x])
    assert s.ORows() == 1 and abs(s.compute(X)[0] - X @ X) < 1e-15
    with pytest.raises(ValueError):
        tast.VectorFunctions.PyVectorFunction(3, 4, callback).compute(X)


def expressions():
    out = []
    for p, pf in zip((jast, tast), both()):
        vf = p.VectorFunctions
        a = vf.Arguments(4)
        inner = vf.stack([a[0] * a[3], vf.cos(a[1]), a[2] + a[3]])
        out.append(vf.stack([pf.eval(inner) * a[3], vf.sin(a[0])]))
    return out


def test_traced_jacobian_in_expression_and_vmap():
    """The callback inside an expression: values and Jacobians of one row
    and of 16 vmapped rows (called row by row), and the adjoint gradient
    (reverse mode through the FD Jacobian), within 1e-10 of JAX."""
    jf, tf = expressions()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 4))
    lam = rng.normal(size=(16, 4))[:, :tf.ORows()]
    assert np.abs(jf.compute(x[0]) - tf.compute(x[0])).max() <= 1e-12
    assert np.abs(jf.jacobian(x[0]) - tf.jacobian(x[0])).max() <= 1e-10
    assert np.abs(jf.adjointgradient(x[0], lam[0])
                  - tf.adjointgradient(x[0], lam[0])).max() <= 1e-10

    def jax_all(x, l):
        return (jf.trace(x), jax.jacfwd(jf.trace)(x),
                jax.vjp(jf.trace, x)[1](l)[0])

    def port_all(x, l):
        return (tf.trace(x), jacfwd(tf.trace)(x),
                vjp(tf.trace, x)[1](l)[0])

    ref = jax.jit(jax.vmap(jax_all))(jnp.asarray(x), jnp.asarray(lam))
    n0 = callback.calls
    got = vmap(port_all)(tast.config.tensor(x), tast.config.tensor(lam))
    # row by row: a value call a row for each of the three passes, and a
    # Jacobian (6 calls) a row for the two derivatives
    assert callback.calls - n0 == 16 * (3 + 2 * 6)
    for a, b in zip(ref, got):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-10


def test_traced_second_derivative_raises():
    """A second derivative through the callback raises in both packages
    (JAX: "Pure callbacks do not support JVP")."""
    jf, tf = expressions()
    x, l = np.array([0.3, 0.2, -0.4, 1.2]), np.array([1.0, 2.0, -1.0])
    with pytest.raises(Exception):
        jf.adjointhessian(x, l)
    with pytest.raises(RuntimeError, match="no derivative"):
        tf.adjointhessian(x, l)
    with pytest.raises(RuntimeError, match="no derivative"):
        jacfwd(jacfwd(tf.trace))(tast.config.tensor(x))


def check_function(fun, X, L, jsize=1e-6, hsize=1e-6,
                   maxjerror=1e-4, maxherror=1e-4):
    """`tests/test_vectorfunctions.py::check_function` on a port
    expression: computeall against FD Jacobians of the function and of its
    adjoint gradient, both built with the port's PyVectorFunction."""
    vf = tast.VectorFunctions
    X = np.asarray(X, dtype=float)
    L = np.asarray(L, dtype=float)
    irows, orows = fun.IRows(), fun.ORows()
    jac_fd = vf.PyVectorFunction(irows, orows, lambda x: fun.compute(x),
                                 jsize, jsize)
    hes_fd = vf.PyVectorFunction(irows, irows,
                                 lambda x: fun.adjointgradient(x, L),
                                 hsize, hsize)
    fx, jx, gx, hx = fun.computeall(X, L)
    assert fx.shape == (orows,) and jx.shape == (orows, irows)
    assert gx.shape == (irows,) and hx.shape == (irows, irows)
    assert np.abs(jx.T @ L - gx).max() < 1e-12
    assert np.abs(jx - jac_fd.jacobian(X)).max() < maxjerror
    hx2 = hes_fd.jacobian(X)
    assert np.abs(hx - (hx2 + hx2.T) / 2).max() < maxherror
    assert np.abs(hx - hx.T).max() < 1e-12


def test_check_function_mirror():
    vf = tast.VectorFunctions
    Args = vf.Arguments
    for n in range(1, 5):
        check_function(Args(n).normalized(),
                       np.arange(1, n + 1, dtype=float),
                       np.arange(2, n + 2, dtype=float))
    a, b, c = Args(3).tolist()
    for fun in (vf.sin(a) * vf.cos(b) + c,
                vf.sqrt(a) * vf.exp(b / 4.0),
                vf.stack([a * b, vf.arctan2(b, c), vf.log(a + 2.0)])):
        check_function(fun, [0.7, -0.4, 1.3], np.arange(1.0, fun.ORows()
                                                        + 1.0))


def test_deriv_checker_matches_jax():
    """FDDerivChecker on the same expression in both packages: the same
    error report (the FD sweeps are host numpy in both), and small
    errors."""
    from asset_asrl_tpu.VectorFunctions.Extensions.DerivChecker import \
        FDDerivChecker as jax_checker
    errs = []
    for p, checker in ((jast, jax_checker), (tast, FDDerivChecker)):
        vf = p.VectorFunctions
        x = vf.Arguments(4)
        fun = vf.stack([x.head3().normalized_power3() * x[3],
                        vf.sin(x[0] * x[1]) + x[2] ** 3])
        errs.append(checker(fun, [0.9, 0.3, -0.5, 1.2], verbose=False))
    for k in ("jac", "grad", "hess"):
        assert errs[1][k] < 1e-5
        assert abs(errs[1][k] - errs[0][k]) <= 1e-6
