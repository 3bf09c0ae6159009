"""Embedded scalar root solve as a differentiable expression node.

Port of `asset_asrl_tpu/VectorFunctions/rootfinder.py` (reference
`src/VectorFunctions/CommonFunctions/RootFinder.h:29-50`, ScalarRootFinder):
given a scalar function FX whose FIRST input is the iteration variable
(its incoming value is the initial guess) and whose remaining inputs are
parameters, the node outputs the root x* with FX(x*, params) = 0,
differentiated with respect to the parameters by the implicit function
theorem.

The JAX package solves with a Newton `lax.while_loop` under
`lax.custom_root`.  Here the Newton solve is `MaxIters` masked steps on
detached inputs: a step is taken while the last step's size is above
`tol`, as the while loop's condition reads, so the root x* equals the JAX
package's step for step and a row of a batch stops where it would alone.
The derivatives come from two differentiable Newton steps taken from x*
on the residual less its own detached value, f(x, p) - f(x*, p): each
step is 0 in value, so the output is x* exactly, and the Newton map's
derivative in x is 0 there, so the first step carries the implicit first
derivative -f_p / f_x and the second the implicit second derivatives
(Jacobians, adjoint gradients and forward-over-reverse adjoint Hessians
all go through them).  Where the count stops the solve short of `tol`,
these are the derivatives of the level set through x*, which is what
`custom_root` differentiates too.
"""

from __future__ import annotations

import torch
from torch.func import jvp

from .function import VectorFunction

__all__ = ["ScalarRootFinder", "RootFinder"]


def ScalarRootFinder(fx, tol=1.0e-12, MaxIters=25):
    """VectorFunction (n -> 1): root of fx's first input.

    fx: VectorFunction with IRows() = n, ORows() = 1; input layout
    [x_guess, params...].  Output: x* with fx(x*, params) = 0.
    """
    if fx.ORows() != 1:
        raise ValueError("ScalarRootFinder requires a scalar function")
    n = fx.IRows()
    trace = fx.trace
    tol = float(tol)
    MaxIters = int(MaxIters)

    def impl(inp):
        def value_slope(z, params):
            """(f, df/dz) at the scalar z (shape (1,))."""
            def f(zz):
                return trace(torch.cat([zz, params]))[0:1]
            return jvp(f, (z,), (torch.ones_like(z),))

        def newton(z, params, level=False):
            fv, dv = value_slope(z, params)
            if level:
                fv = fv - fv.detach()
            return fv / torch.where(torch.abs(dv) > 1e-300, dv,
                                    torch.ones_like(dv))

        z = inp[0:1].detach()
        p = inp[1:].detach()
        err = torch.full_like(z, float("inf"))
        for _ in range(MaxIters):
            active = err > tol
            step = newton(z, p)
            z = torch.where(active, z - step, z)
            err = torch.where(active, torch.abs(step), err)
        params = inp[1:]
        for _ in range(2):
            z = z - newton(z, params, level=True)
        return z

    return VectorFunction(impl, n, 1, name="ScalarRootFinder")


# reference exposes the same node under both names
RootFinder = ScalarRootFinder
