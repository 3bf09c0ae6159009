"""Hermite-Legendre-Gauss-Lobatto collocation, worked out from the Legendre
polynomial for the plain references.

A segment with `cs` cardinal states takes the (2 cs - 1)-point
Gauss-Lobatto rule on [0, 1]: the cardinal states sit at its even points,
the collocation points at its odd ones.  The state between the cardinals
is the Hermite interpolant of the cardinal states and their rates (degree
2 cs - 1); the control is the Lagrange polynomial through the cardinal
controls (degree cs - 1).  The defect at collocation point i is

    w_i * (h f(x_i, u_i, t_i) - p'(tau_i))

with w_i the point's Lobatto weight, h the segment's length in time and
p the interpolant in the local time tau.  The integral objective takes the
cardinal-only rule that is exact for degree cs - 1.

Only numpy: this module imports nothing of the program.
"""

import numpy as np
from numpy.polynomial import Polynomial, legendre


def lobatto(n):
    """The n-point Gauss-Lobatto nodes and weights on [0, 1]: the ends and
    the roots of P'_{n-1}, with weights 2 / (n (n - 1) P_{n-1}(x)^2) on
    [-1, 1]."""
    p = legendre.Legendre.basis(n - 1)
    x = np.concatenate([[-1.0], np.sort(p.deriv().roots().real), [1.0]])
    w = 2.0 / (n * (n - 1) * p(x) ** 2)
    return (x + 1.0) / 2.0, w / 2.0


def _lagrange(nodes, j):
    """The Lagrange basis polynomial of node j through `nodes`."""
    poly = Polynomial([1.0])
    for k, t in enumerate(nodes):
        if k != j:
            poly = poly * Polynomial([-t, 1.0]) / (nodes[j] - t)
    return poly


class Scheme:
    """The tables of one scheme, as plain arrays (C = cs cardinals, I =
    cs - 1 collocation points):

    cardinal (C,), interior (I,): local times;
    weight (I,): the Lobatto weight of each collocation point;
    hx, hf (I, C): p(tau_i) = hx @ x + hf @ (h f);
    dhx, dhf (I, C): p'(tau_i) = dhx @ x + dhf @ (h f);
    lu (I, C): u(tau_i) = lu @ u;
    quad (C,): the cardinal-only quadrature weights on [0, 1]."""

    def __init__(self, cs):
        pts, wts = lobatto(2 * cs - 1)
        self.cardinal, self.interior = pts[0::2], pts[1::2]
        self.weight = wts[1::2]
        C, I = cs, cs - 1
        self.hx, self.hf = np.zeros((I, C)), np.zeros((I, C))
        self.dhx, self.dhf = np.zeros((I, C)), np.zeros((I, C))
        self.lu = np.zeros((I, C))
        self.quad = np.zeros(C)
        for j, tj in enumerate(self.cardinal):
            L = _lagrange(self.cardinal, j)
            # Hermite basis: value 1 (rate 0) at tj, and value 0 (rate 1)
            H = (1.0 - 2.0 * L.deriv()(tj) * Polynomial([-tj, 1.0])) * L * L
            K = Polynomial([-tj, 1.0]) * L * L
            self.hx[:, j], self.hf[:, j] = H(self.interior), K(self.interior)
            self.dhx[:, j] = H.deriv()(self.interior)
            self.dhf[:, j] = K.deriv()(self.interior)
            self.lu[:, j] = L(self.interior)
            self.quad[j] = L.integ()(1.0) - L.integ()(0.0)
