"""PyVectorFunction: wrap an arbitrary Python callable as a VectorFunction
with finite-difference derivatives.

Port of `asset_asrl_tpu/VectorFunctions/pyfunc.py` (reference
`src/VectorFunctions/CommonFunctions/PythonFunctions.h`).  Central
differences give the Jacobian, differences of adjoint gradients the
Hessian.

It behaves as the JAX package's does, no more:

* the host methods (`compute`, `jacobian`, `adjointgradient`,
  `adjointhessian`, `computeall`) are numpy finite differences on the
  host, line for line the JAX package's;
* inside an expression the callable runs through a
  `torch.autograd.Function` (the JAX package's `pure_callback`): the
  callable gets one row as a float64 numpy array on the host, so each call
  pays one device-to-host copy and one copy back, as the JAX callback
  does; under `vmap` it is called row by row (the JAX package's
  `vmap_method="sequential"`);
* the first derivative inside an expression (forward or reverse) is the
  FD Jacobian; a second derivative raises, as JAX's "Pure callbacks do
  not support JVP" does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import config
from .function import VectorFunction

__all__ = ["PyVectorFunction", "PyScalarFunction"]

_NO_SECOND = ("PyVectorFunction: the finite-difference Jacobian of a "
              "Python callback has no derivative (the JAX package raises "
              "'Pure callbacks do not support JVP' here too)")


def _rows(fn, x, bdim, *rest):
    """`fn` applied to each row of x along `bdim`, stacked on axis 0."""
    return torch.stack([fn.apply(r, *rest)
                        for r in x.movedim(bdim, 0).unbind(0)]), 0


def _host(x, fn):
    out = fn(x.detach().cpu().numpy())
    return config.tensor(out, x.device)


class _HostJacobian(torch.autograd.Function):
    """The FD Jacobian of one row, computed on the host; not
    differentiable."""

    @staticmethod
    def forward(x, pyf):
        return _host(x, pyf._fd_jacobian)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(_NO_SECOND)

    @staticmethod
    def jvp(ctx, dx, _):
        raise RuntimeError(_NO_SECOND)

    @staticmethod
    def vmap(info, in_dims, x, pyf):
        if in_dims[0] is None:
            return _HostJacobian.apply(x, pyf), None
        return _rows(_HostJacobian, x, in_dims[0], pyf)


class _HostCall(torch.autograd.Function):
    """The callable on one row, on the host; its derivative is the FD
    Jacobian."""

    @staticmethod
    def forward(x, pyf):
        return _host(x, pyf._host_eval)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, pyf = inputs
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.pyf = pyf

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g @ _HostJacobian.apply(x, ctx.pyf), None

    @staticmethod
    def jvp(ctx, dx, _):
        x, = ctx.saved_tensors
        return _HostJacobian.apply(x, ctx.pyf) @ dx

    @staticmethod
    def vmap(info, in_dims, x, pyf):
        if in_dims[0] is None:
            return _HostCall.apply(x, pyf), None
        return _rows(_HostCall, x, in_dims[0], pyf)


class PyVectorFunction(VectorFunction):

    def __init__(self, irows, orows, func, jstepsize=1.0e-6, hstepsize=1.0e-6,
                 args=()):
        irows, orows = int(irows), int(orows)
        self._pyfunc = func
        self._extra = tuple(args)
        self._jstep = float(jstepsize)
        self._hstep = float(hstepsize)

        def host_eval(x):
            out = np.asarray(self._pyfunc(np.asarray(x, dtype=np.float64),
                                          *self._extra),
                             dtype=np.float64).ravel()
            if out.shape[0] != orows:
                raise ValueError(
                    f"PyVectorFunction returned size {out.shape[0]}, "
                    f"expected {orows}")
            return out

        self._host_eval = host_eval
        super().__init__(lambda x: _HostCall.apply(x, self), irows, orows,
                         name="PyVectorFunction")

    # ------------------------------------------------------- finite difference
    def _fd_jacobian(self, x, step=None):
        step = self._jstep if step is None else step
        n, m = self.IRows(), self.ORows()
        jac = np.zeros((m, n))
        for i in range(n):
            xp = x.copy(); xp[i] += step
            xm = x.copy(); xm[i] -= step
            jac[:, i] = (self._host_eval(xp) - self._host_eval(xm)) / (2 * step)
        return jac

    def compute(self, x):
        return self._host_eval(np.asarray(x, dtype=np.float64).ravel())

    def jacobian(self, x):
        return self._fd_jacobian(np.asarray(x, dtype=np.float64).ravel())

    def adjointgradient(self, x, l):
        jac = self.jacobian(x)
        return jac.T @ np.asarray(l, dtype=np.float64).ravel()

    def adjointhessian(self, x, l):
        x = np.asarray(x, dtype=np.float64).ravel()
        l = np.asarray(l, dtype=np.float64).ravel()
        n = self.IRows()
        step = self._hstep
        hess = np.zeros((n, n))
        for i in range(n):
            xp = x.copy(); xp[i] += step
            xm = x.copy(); xm[i] -= step
            gp = self._fd_jacobian(xp, step=step).T @ l
            gm = self._fd_jacobian(xm, step=step).T @ l
            hess[:, i] = (gp - gm) / (2 * step)
        return 0.5 * (hess + hess.T)

    def computeall(self, x, l):
        return (self.compute(x), self.jacobian(x),
                self.adjointgradient(x, l), self.adjointhessian(x, l))


def PyScalarFunction(irows, func, jstepsize=1.0e-6, hstepsize=1.0e-6, args=()):
    return PyVectorFunction(irows, 1, func, jstepsize, hstepsize, args=args)
