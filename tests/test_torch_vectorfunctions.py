"""VectorFunctions parity: the CartPole ODE in the port against the JAX
package (whose evaluators are jitted), at seeded points."""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from chip_smoke import cartpole_ode

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

TOL = 1e-12


@pytest.fixture(scope="module")
def odes():
    return cartpole_ode(jast).vf(), cartpole_ode(tast).vf()


def points(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=6) * 2.0, rng.normal(size=4))
            for _ in range(n)]


@pytest.mark.parametrize("which", ["compute", "jacobian"])
def test_cartpole_value_and_jacobian(odes, which):
    fj, ft = odes
    for x, _ in points():
        a = getattr(fj, which)(x)
        b = getattr(ft, which)(x)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("which", ["adjointgradient", "adjointhessian"])
def test_cartpole_adjoints(odes, which):
    fj, ft = odes
    for x, lam in points():
        a = getattr(fj, which)(x, lam)
        b = getattr(ft, which)(x, lam)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * max(1.0, np.abs(a).max())


def test_adjoint_gradient_is_jt_lambda(odes):
    _, ft = odes
    for x, lam in points(seed=1):
        fx, jx, gx, hx = ft.computeall(x, lam)
        assert fx.shape == (4,) and jx.shape == (4, 6)
        assert np.abs(jx.T @ lam - gx).max() < 1e-12
        assert np.abs(hx - hx.T).max() < 1e-12


def test_matrix_inverse_2x2_matches_numpy():
    vf = tast.VectorFunctions
    M = vf.RowMatrix(vf.Arguments(4), 2, 2).inverse()
    x = np.array([2.0, 0.5, -1.0, 3.0])
    got = M.compute(x).reshape(2, 2, order="F")
    assert np.abs(got - np.linalg.inv(x.reshape(2, 2))).max() < 1e-15
