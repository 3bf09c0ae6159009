"""Differentiable 1-4D interpolation tables.

Port of `asset_asrl_tpu/VectorFunctions/interp.py` (reference
`src/VectorFunctions/CommonFunctions/InterpTable{1,2,3,4}D.h`): linear and
cubic lookup tables on rectilinear, possibly non-uniform, grids, bindable
as VectorFunctions (the aero and thrust data of MinimumTimeToClimb).

Cubic mode is a tensor-product Catmull-Rom (C1) whose per-axis 4-point
cardinal weights are computed in the closure from the local knot spacing,
so `torch.func` differentiates the interpolant exactly.  Two details keep
the derivatives equal to the JAX package's:

* the query is clamped to the table's ends with `config.clip`, whose
  derivative at a tie is 1/2 as `jnp.clip`'s is (`torch.clamp` gives 1),
  so a query exactly on the first or last knot has JAX's derivative;
* the knot interval comes from `torch.searchsorted` on the detached query
  as a one-element index tensor, and every read of the knots and of the
  data's hypercube is a `torch.index_select`, which runs under
  `vmap(jacfwd(...))` where a batched `ts[j]` does not.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from .function import VectorFunction, as_function, _stack_arg

__all__ = ["InterpTable1D", "InterpTable2D", "InterpTable3D",
           "InterpTable4D"]


def _take(v, i):
    return torch.index_select(v, 0, i)


def _axis_weights_cubic(ts, x):
    """4-point Catmull-Rom cardinal weights on a non-uniform axis `ts`
    (a tensor) at the query x (shape (1,)).  Returns (idx (4,), w (4,))
    with value = sum_k w[k] f[idx[k]], clamped ends."""
    n = ts.shape[0]
    x = config.clip(x, ts[0:1], ts[n - 1:n])
    j = torch.clamp(torch.searchsorted(ts, x.detach(), right=True) - 1,
                    0, n - 2)
    t0 = _take(ts, j)
    t1 = _take(ts, j + 1)
    h = t1 - t0
    s = (x - t0) / h
    # Hermite basis
    h00 = 2 * s ** 3 - 3 * s ** 2 + 1
    h10 = s ** 3 - 2 * s ** 2 + s
    h01 = -2 * s ** 3 + 3 * s ** 2
    h11 = s ** 3 - s ** 2
    # Catmull-Rom tangents on non-uniform knots: second-order weighted
    # central differences, one-sided at the ends, as weights on
    # f[j-1..j+2]
    jm = torch.clamp(j - 1, 0, n - 1)
    jp2 = torch.clamp(j + 2, 0, n - 1)
    tm = _take(ts, jm)
    tp2 = _take(ts, jp2)
    one = torch.ones_like(h)
    h0 = t0 - tm          # left gap at t0 (0 at the boundary)
    h0s = torch.where(h0 > 0, h0, one)
    m0_w = torch.where(
        j > 0,
        torch.cat([-h / ((h0s + h) * h0s),
                   h / ((h0s + h) * h0s) - h0 / ((h0s + h) * h),
                   h0 / ((h0s + h) * h)]),
        torch.cat([0.0 * h, -1.0 / h, 1.0 / h]))
    g1 = tp2 - t1         # right gap at t1 (0 at the boundary)
    g1s = torch.where(g1 > 0, g1, one)
    m1_w = torch.where(
        j < n - 2,
        torch.cat([-g1 / ((h + g1s) * h),
                   g1 / ((h + g1s) * h) - h / ((h + g1s) * g1s),
                   h / ((h + g1s) * g1s)]),
        torch.cat([-1.0 / h, 1.0 / h, 0.0 * h]))
    # m0 acts on (f[jm], f[j], f[j+1]); m1 on (f[j], f[j+1], f[jp2]); the
    # sums in the JAX package's order of accumulation
    a, b = h10 * h, h11 * h
    w = torch.cat([a * m0_w[0:1],
                   h00 + a * m0_w[1:2] + b * m1_w[0:1],
                   h01 + a * m0_w[2:3] + b * m1_w[1:2],
                   b * m1_w[2:3]])
    return torch.cat([jm, j, j + 1, jp2]), w


def _axis_weights_linear(ts, x):
    n = ts.shape[0]
    x = config.clip(x, ts[0:1], ts[n - 1:n])
    j = torch.clamp(torch.searchsorted(ts, x.detach(), right=True) - 1,
                    0, n - 2)
    t0 = _take(ts, j)
    s = (x - t0) / (_take(ts, j + 1) - t0)
    return torch.cat([j, j + 1]), torch.cat([1.0 - s, s])


class _InterpTableND:
    """N-D rectilinear interpolation table; calling it with N scalar
    functions (or numbers) returns a scalar VectorFunction."""

    def __init__(self, axes, data, kind="cubic"):
        self.axes = [np.asarray(a, dtype=np.float64) for a in axes]
        data = np.asarray(data, dtype=np.float64)
        if data.shape != tuple(len(a) for a in self.axes):
            raise ValueError(
                f"data shape {data.shape} does not match axis lengths "
                f"{tuple(len(a) for a in self.axes)}")
        self.data = data
        self.kind = str(kind)
        self.ndim = len(self.axes)
        self._dev = {}

    def _tensors(self, device):
        """(axes, flat data, strides) as tensors on `device`, built at
        first use there."""
        got = self._dev.get(device)
        if got is None:
            strides = np.cumprod([1] + [len(a) for a in self.axes[:0:-1]])
            got = ([config.cached(a, device) for a in self.axes],
                   config.cached(self.data.reshape(-1), device),
                   [int(s) for s in strides[::-1]])
            self._dev[device] = got
        return got

    def interp_traced(self, coords):
        """coords: ndim scalar tensors -> interpolated value, shape (1,)."""
        wfun = _axis_weights_cubic if self.kind == "cubic" \
            else _axis_weights_linear
        coords = [c.reshape(1) for c in coords]
        axes, flat, strides = self._tensors(coords[0].device)
        idxs, wts = [], []
        for ax, x in zip(axes, coords):
            i, w = wfun(ax, x)
            idxs.append(i)
            wts.append(w)
        # tensor-product contraction over the gathered hypercube: flat
        # indices of its corners, one gather, then the last axis first
        m = idxs[0].shape[0]
        lin = idxs[0] * strides[0]
        for i, st in zip(idxs[1:], strides[1:]):
            lin = (lin[..., None] + i * st)
        cube = _take(flat, lin.reshape(-1)).reshape((m,) * self.ndim)
        for w in reversed(wts):
            cube = cube @ w
        return cube.reshape(1)

    def __call__(self, *args):
        if len(args) != self.ndim:
            if len(args) == 1 and isinstance(args[0], VectorFunction) \
                    and args[0].ORows() == self.ndim:
                fn = args[0]._fn
                tab = self

                def impl(x):
                    c = torch.atleast_1d(fn(x))
                    return tab.interp_traced(
                        [c[i] for i in range(tab.ndim)])
                return VectorFunction(impl, args[0].IRows(), 1,
                                      name="InterpTable")
            raise ValueError(f"table takes {self.ndim} arguments")
        if all(not isinstance(a, VectorFunction) for a in args):
            return self.interp(*args)
        funcs = [a for a in args if isinstance(a, VectorFunction)]
        ir = funcs[0].IRows()
        args = [a if isinstance(a, VectorFunction) else as_function(a, ir)
                for a in args]
        fns = [a._fn for a in args]
        tab = self

        def impl(x):
            return tab.interp_traced([torch.atleast_1d(f(x))[0]
                                      for f in fns])
        return VectorFunction(impl, ir, 1, name="InterpTable")

    # stand-alone numeric evaluation
    def interp(self, *coords):
        return float(self.interp_traced(
            [config.tensor(float(c)) for c in coords])[0])


def InterpTable1D(ts, vals, kind="cubic", axis=0):
    vals = np.asarray(vals, dtype=np.float64)
    if vals.ndim == 2:
        # vector-valued 1D table: one table per column, stacked
        if vals.shape[0] != len(ts):
            vals = vals.T
        tabs = [_InterpTableND([ts], vals[:, j], kind)
                for j in range(vals.shape[1])]

        class _VecTab:
            def __call__(self, tfunc):
                from .function import stack
                tfunc = _stack_arg(tfunc)
                return stack([t(tfunc) for t in tabs])
        return _VecTab()
    return _InterpTableND([ts], vals, kind)


def InterpTable2D(xs, ys, data, kind="cubic"):
    # reference convention (`InterpTable2D.h:72-75`): data rows = ys,
    # cols = xs (matrix/meshgrid layout); stored x-major
    data = np.asarray(data, dtype=np.float64)
    if data.shape == (len(ys), len(xs)):
        data = data.T
    return _InterpTableND([xs, ys], data, kind)


def InterpTable3D(xs, ys, zs, data, kind="cubic", cache=False):
    return _InterpTableND([xs, ys, zs], data, kind)


def InterpTable4D(xs, ys, zs, ws, data, kind="cubic", cache=False):
    return _InterpTableND([xs, ys, zs, ws], data, kind)
