"""FiniteDiffTable: arbitrary-grid finite-difference differentiation of
tabulated trajectories.

The port's own copy of `asset_asrl_tpu/OptimalControl/fdtable.py` (numpy
only): `oc.FiniteDiffTable(axis, data)` with `.deriv(i, order, accuracy)`
and `.all_derivs(order, accuracy)`.  Stencil weights come from the classic
Fornberg recurrence on the local (possibly non-uniform) abscissa window,
exact for polynomials of the stencil degree."""

from __future__ import annotations

import numpy as np

__all__ = ["FiniteDiffTable", "fornberg_weights", "FDiffData"]


def fornberg_weights(z, x, m):
    """Weights w[k] with f^(m)(z) ~ sum_k w[k] f(x[k]) on abscissas x
    (Fornberg 1988, standard recurrence)."""
    x = np.asarray(x, np.float64)
    n = len(x)
    c = np.zeros((n, m + 1))
    c1 = 1.0
    c4 = x[0] - z
    c[0, 0] = 1.0
    for i in range(1, n):
        mn = min(i, m)
        c2 = 1.0
        c5 = c4
        c4 = x[i] - z
        for j in range(i):
            c3 = x[i] - x[j]
            c2 *= c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    c[i, k] = c1 * (k * c[i - 1, k - 1]
                                    - c5 * c[i - 1, k]) / c2
                c[i, 0] = -c1 * c5 * c[i - 1, 0] / c2
            for k in range(mn, 0, -1):
                c[j, k] = (c4 * c[j, k] - k * c[j, k - 1]) / c3
            c[j, 0] = c4 * c[j, 0] / c3
        c1 = c2
    return c[:, m]


class FiniteDiffTable:
    """FD differentiation of a list of state rows along a time axis."""

    def __init__(self, axis, data):
        self.axis = int(axis)
        self.data = np.asarray(
            [np.asarray(r, np.float64).ravel() for r in data])
        self.length = self.data.shape[0]

    def _stencil(self, i, order, accuracy):
        acc = 2 * ((accuracy + 1) // 2)
        size = order + acc - (1 if order % 2 == 0 else 0)
        size = max(size, order + 1)
        if size > self.length:
            raise ValueError("requested accuracy too high for given data")
        lo = int(np.clip(i - size // 2, 0, self.length - size))
        return lo, lo + size

    def deriv(self, i, order, accuracy=2):
        """order-th derivative of every column at row i."""
        lo, hi = self._stencil(i, order, accuracy)
        ts = self.data[lo:hi, self.axis]
        w = fornberg_weights(self.data[i, self.axis], ts, order)
        return w @ self.data[lo:hi]

    def all_derivs(self, order, accuracy=2):
        return [self.deriv(i, order, accuracy)
                for i in range(self.length)]


def FDiffData(rows, axis, inctime=True):
    """4th/1st-order FD of the leading `axis` columns of uniform-grid
    rows."""
    tab = FiniteDiffTable(axis, rows)
    out = []
    for i in range(tab.length):
        d = tab.deriv(i, 1, 4)
        row = np.array(rows[i], np.float64, copy=True)
        row[:axis] = d[:axis]
        out.append(row if inctime else row[:axis])
    return out
