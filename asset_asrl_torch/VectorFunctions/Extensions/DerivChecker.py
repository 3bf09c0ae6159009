"""FDDerivChecker: finite-difference sweep of any VectorFunction.

Port of `asset_asrl_tpu/VectorFunctions/Extensions/DerivChecker.py`
(reference `asset_asrl/VectorFunctions/Extensions/DerivChecker.py`): the
developer tool used throughout the reference test suite to validate
analytic first/second derivatives against central differences at a point.
"""

import numpy as np

from ..pyfunc import PyVectorFunction


def FDDerivChecker(fun, X, L=None, jstep=1e-6, hstep=1e-5, verbose=True):
    """Compare fun.computeall derivatives against finite differences.

    Returns dict with max errors {jac, grad, hess}; prints a report when
    verbose."""
    X = np.asarray(X, dtype=np.float64).ravel()
    ir, orr = fun.IRows(), fun.ORows()
    if L is None:
        L = np.arange(1.0, orr + 1.0)
    L = np.asarray(L, dtype=np.float64).ravel()

    fx, jx, gx, hx = fun.computeall(X, L)

    jac_fd = PyVectorFunction(ir, orr, lambda x: fun.compute(x),
                              jstep, jstep).jacobian(X)
    hes_fd = PyVectorFunction(ir, ir, lambda x: fun.adjointgradient(x, L),
                              hstep, hstep).jacobian(X)
    hes_fd = 0.5 * (hes_fd + hes_fd.T)

    errs = dict(
        jac=float(np.abs(jx - jac_fd).max()),
        grad=float(np.abs(jx.T @ L - gx).max()),
        hess=float(np.abs(hx - hes_fd).max()))
    if verbose:
        print(f"FDDerivChecker: |J - J_fd| = {errs['jac']:.3e}  "
              f"|J^T L - g| = {errs['grad']:.3e}  "
              f"|H - H_fd| = {errs['hess']:.3e}")
    return errs
