"""The root-finder node of the port (`asset_asrl_torch.VectorFunctions.
ScalarRootFinder`) against the JAX package's (`lax.custom_root`): Kepler's
equation inside an expression, as `tests/test_astro.py::
test_rootfinder_node`, and a family holding the node, whose values,
Jacobians and adjoint Hessians over seeded rows (vmapped in both
packages) must agree within 1e-10; also with `MaxIters` too small to reach
`tol`, where both packages stop on the count."""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from chip_smoke import kepler_family, kepler_rows
from test_torch_interp import family_pair

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


def test_rootfinder_node():
    vf = tast.VectorFunctions
    X = vf.Arguments(3)    # [E_guess, e, M]
    rf = vf.ScalarRootFinder(X[0] - X[1] * vf.sin(X[0]) - X[2])
    e, M = 0.3, 1.1
    inp = np.array([M, e, M])
    E = float(rf.compute(inp)[0])
    assert abs(E - e * np.sin(E) - M) < 1e-11
    J = rf.jacobian(inp)
    dEdM = 1.0 / (1.0 - e * np.cos(E))
    assert abs(J[0, 2] - dEdM) < 1e-9
    assert abs(J[0, 0]) < 1e-9      # no dependence on the guess
    assert vf.RootFinder is vf.ScalarRootFinder


@pytest.mark.parametrize("kw", [{}, {"tol": 1e-15, "MaxIters": 3}],
                         ids=["converged", "MaxIters"])
def test_family_matches_jax(kw):
    """Values, Jacobians and forward-over-reverse adjoint Hessians of a
    family holding the node, over 32 seeded rows, within 1e-10 of the JAX
    package.  With MaxIters=3 and tol=1e-15 neither package reaches tol:
    both return the third Newton iterate and its level-set derivatives."""
    x, lam = kepler_rows(32, seed=4)
    ref, got = family_pair(kepler_family(jast, **kw),
                           kepler_family(tast, **kw), x, lam)
    for a, b in zip(ref, got):
        assert np.abs(a - b).max() <= 1e-10 * max(1, np.abs(a).max())
    tf = kepler_family(tast, **kw)
    # one row alone (computeall) equals its row of the family
    one = tf.computeall(x[5], lam[5])
    assert np.abs(one[0] - got[0][5]).max() == 0
    assert np.abs(one[3] - got[2][5]).max() <= 1e-14
    if kw:
        # short of tol: the residual of the third iterate is not 0
        vf = tast.VectorFunctions
        X = vf.Arguments(3)
        node = vf.ScalarRootFinder(X[0] - X[1] * vf.sin(X[0]) - X[2], **kw)
        r = np.array([node.compute(row)[0] for row in x])
        res = np.abs(r - x[:, 1] * np.sin(r) - x[:, 2]).max()
        assert res > 1e-13
