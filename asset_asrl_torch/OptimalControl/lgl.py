"""Gauss-Lobatto (LGL) collocation coefficients, derived from first
principles.

The reference hardcodes these tables (`src/OptimalControl/LGLCoeffs.h`) for
the Herman-Conway style LGL3/LGL5/LGL7 schemes.  Here they are *derived*:

For a scheme with CS cardinal states per segment, the full node set is the
(2*CS-1)-point Gauss-Lobatto set on [0,1].  Cardinal states sit at the
even-indexed Lobatto points, interior (collocation) points at the odd ones.
The Hermite interpolant p of degree 2*CS-1 matches (x_j, h*f_j) at all
cardinal points; interior states are p(tau_i), and the defect at interior
point i is

    defect_i = w_i * ( h*f(interior_i) - p'(tau_i) )

with w_i the [0,1] Lobatto quadrature weight — expanding p'(tau_i) in the
(x_j, h*f_j) basis reproduces the reference's Cardinal_XDef / Cardinal_DXDef /
Interior_DXDef weight tables to machine precision (verified in
tests/test_lgl.py).  Controls are interpolated with the degree CS-1 Lagrange
polynomial through the cardinal controls (Cardinal_UPoly weights).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from numpy.polynomial import legendre


def lobatto_points_weights(n):
    """n-point Gauss-Lobatto quadrature nodes/weights on [0,1]."""
    c = np.zeros(n)
    c[-1] = 1.0  # Legendre series for P_{n-1}
    xi = legendre.legroots(legendre.legder(c))
    x = np.concatenate([[-1.0], xi, [1.0]])
    pn1 = legendre.legval(x, c)
    w = 2.0 / (n * (n - 1) * pn1 ** 2)
    return (x + 1.0) / 2.0, w / 2.0


def _poly_powers(tau, deg):
    return tau ** np.arange(deg + 1)


def _dpoly_powers(tau, deg):
    k = np.arange(deg + 1)
    out = np.zeros(deg + 1)
    out[1:] = k[1:] * tau ** (k[1:] - 1)
    return out


def lagrange_weights(nodes, tau):
    """Values of the Lagrange basis polynomials through `nodes` at tau."""
    nodes = np.asarray(nodes, dtype=float)
    out = np.empty(len(nodes))
    for j in range(len(nodes)):
        others = np.delete(nodes, j)
        out[j] = np.prod((tau - others) / (nodes[j] - others))
    return out


def lagrange_deriv_weights(nodes, tau):
    """Derivative of the Lagrange basis polynomials at tau."""
    nodes = np.asarray(nodes, dtype=float)
    n = len(nodes)
    out = np.zeros(n)
    for j in range(n):
        others = np.delete(nodes, j)
        denom = np.prod(nodes[j] - others)
        s = 0.0
        for k in range(n - 1):
            rest = np.delete(others, k)
            s += np.prod(tau - rest)
        out[j] = s / denom
    return out


class LGLScheme:
    """All coefficient tables for a CS-cardinal LGL collocation scheme.

    Attributes (shapes; I = CS-1 interior points, C = CS cardinals):
      cardinal_tau (C,), interior_tau (I,): local [0,1] positions
      x_interp (I, C), dx_interp (I, C): interior state from (x_j, h*f_j)
      u_interp (I, C): interior control from cardinal controls
      x_def (I, C), dx_def (I, C), int_def (I,): defect weights
      quad_cardinal (C,), quad_interior (I,): full Lobatto quadrature on [0,1]
      quad_reduced (C,): cardinal-only quadrature (exactness degree C-1)
      u_dtau0 (C,), u_dtau1 (C,): control poly d/dtau at segment ends
      order: polynomial order of the scheme (2*CS-1)
    """

    def __init__(self, cs):
        cs = int(cs)
        if cs < 2:
            raise ValueError("LGL scheme needs >= 2 cardinal states")
        self.cs = cs
        npts = 2 * cs - 1
        pts, wts = lobatto_points_weights(npts)
        self.cardinal_tau = pts[0::2].copy()
        self.interior_tau = pts[1::2].copy()
        wc = wts[0::2].copy()
        wi = wts[1::2].copy()
        self.quad_cardinal = wc
        self.quad_interior = wi
        self.order = 2 * cs - 1

        deg = 2 * cs - 1
        # Hermite condition matrix: p(tc_j) = x_j, p'(tc_j) = hf_j
        A = np.zeros((2 * cs, deg + 1))
        for j, tc in enumerate(self.cardinal_tau):
            A[j] = _poly_powers(tc, deg)
            A[cs + j] = _dpoly_powers(tc, deg)
        Ainv = np.linalg.inv(A)  # coeffs = Ainv @ [x; hf]

        ni = cs - 1
        self.x_interp = np.zeros((ni, cs))
        self.dx_interp = np.zeros((ni, cs))
        self.x_def = np.zeros((ni, cs))
        self.dx_def = np.zeros((ni, cs))
        self.int_def = np.zeros(ni)
        for i, ti in enumerate(self.interior_tau):
            row_p = _poly_powers(ti, deg) @ Ainv       # p(ti) in (x, hf) basis
            row_dp = _dpoly_powers(ti, deg) @ Ainv     # p'(ti)
            self.x_interp[i] = row_p[:cs]
            self.dx_interp[i] = row_p[cs:]
            w = wi[i]
            self.x_def[i] = -w * row_dp[:cs]
            self.dx_def[i] = -w * row_dp[cs:]
            self.int_def[i] = w

        # control interpolation (degree cs-1 Lagrange through cardinals)
        self.u_interp = np.stack([
            lagrange_weights(self.cardinal_tau, ti)
            for ti in self.interior_tau])
        self.u_dtau0 = lagrange_deriv_weights(self.cardinal_tau, 0.0)
        self.u_dtau1 = lagrange_deriv_weights(self.cardinal_tau, 1.0)

        # cardinal-only ("reduced") quadrature: exact for degree cs-1
        # (solve Vandermonde moment conditions on [0,1])
        V = np.vander(self.cardinal_tau, cs, increasing=True).T
        m = 1.0 / np.arange(1, cs + 1)
        self.quad_reduced = np.linalg.solve(V, m)

        # de Boor mesh-error weight: the local truncation constant of the
        # scheme (reference LGLCoeffs ErrorWeight); derived from the order.
        self.error_weight = float(
            np.abs(self._truncation_constant()))

    def _truncation_constant(self):
        """Estimate the defect truncation constant by probing with the
        monomial t^(order+1) (first polynomial the scheme cannot match)."""
        deg = self.order + 1
        x = self.cardinal_tau ** deg
        hf = deg * self.cardinal_tau ** (deg - 1)
        res = 0.0
        for i, ti in enumerate(self.interior_tau):
            fi = deg * ti ** (deg - 1)
            p_dx = self.x_def[i] @ x + self.dx_def[i] @ hf
            res = max(res, abs(p_dx + self.int_def[i] * fi))
        return res


_SCHEMES = {}


def get_scheme(mode) -> LGLScheme:
    """LGLScheme by transcription-mode name ('LGL3' -> CS=2, etc.)."""
    cs = {"LGL3": 2, "LGL5": 3, "LGL7": 4, "LGL9": 5}.get(mode)
    if cs is None:
        raise ValueError(f"not an LGL transcription mode: {mode}")
    if cs not in _SCHEMES:
        _SCHEMES[cs] = LGLScheme(cs)
    return _SCHEMES[cs]
