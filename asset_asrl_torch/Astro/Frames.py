"""Dynamical frames: canonical unit systems + EOM builders.

Port of `asset_asrl_tpu/Astro/Frames.py` (reference
`asset_asrl/Astro/Extensions/{TwoBodyFrame,CR3BPFrame,
MEETwoBodyFrame}.py`): a frame holds the canonical length/time units and
builds the ballistic equations of motion as vf expressions, to which model
classes append thrust/perturbation accelerations.
"""

from __future__ import annotations

import numpy as np

from .. import VectorFunctions as vf
from ..VectorFunctions.function import Arguments


class TwoBodyFrame:

    def __init__(self, P1mu, lstar):
        self.P1mu = P1mu
        self.lstar = lstar
        self.mustar = P1mu
        self.tstar = np.sqrt(lstar ** 3 / P1mu)
        self.vstar = lstar / self.tstar
        self.astar = lstar / self.tstar ** 2
        self.mu = 1.0  # canonical

    def TwoBodyEOMs(self, r, v, otherAccs=[], otherEOMs=[]):
        acc = -self.mu * r.normalized_power3()
        for a in otherAccs:
            acc = acc + a
        return vf.stack([v, acc] + list(otherEOMs))


class CR3BPFrame:

    def __init__(self, P1mu, P2mu, lstar):
        self.P1mu = P1mu
        self.P2mu = P2mu
        self.lstar = lstar
        self.mustar = P1mu + P2mu
        self.mu = P2mu / (P1mu + P2mu)
        self.tstar = np.sqrt(lstar ** 3 / (P1mu + P2mu))
        self.vstar = lstar / self.tstar
        self.astar = lstar / self.tstar ** 2
        self.P1 = np.array([-self.mu, 0, 0])
        self.P2 = np.array([1.0 - self.mu, 0, 0])
        self._calc_lpoints()

    def _calc_lpoints(self):
        """Collinear Lagrange points by Newton iteration + triangular pts."""
        mu = self.mu

        def dUdx(x):
            r1 = abs(x + mu)
            r2 = abs(x - 1 + mu)
            return x - (1 - mu) * (x + mu) / r1 ** 3 \
                - mu * (x - 1 + mu) / r2 ** 3

        def solve(x0):
            x = x0
            for _ in range(100):
                h = 1e-7
                d = (dUdx(x + h) - dUdx(x - h)) / (2 * h)
                x = x - dUdx(x) / d
            return x

        self.L1 = np.array([solve(1 - mu - (mu / 3) ** (1 / 3)), 0, 0])
        self.L2 = np.array([solve(1 - mu + (mu / 3) ** (1 / 3)), 0, 0])
        self.L3 = np.array([solve(-1 - 5 * mu / 12), 0, 0])
        self.L4 = np.array([0.5 - mu, np.sqrt(3) / 2, 0])
        self.L5 = np.array([0.5 - mu, -np.sqrt(3) / 2, 0])

    def CR3BPEOMs(self, r, v, otherAccs=[], otherEOMs=[]):
        mu = self.mu
        x, y = r[0], r[1]
        vx, vy = v[0], v[1]
        r1 = r - np.array([-mu, 0, 0])
        r2 = r - np.array([1 - mu, 0, 0])
        grav = (-(1.0 - mu)) * r1.normalized_power3() \
            + (-mu) * r2.normalized_power3()
        # rotating-frame terms: 2 Omega x v + centrifugal
        rot = vf.stack([2.0 * vy + x, -2.0 * vx + y, 0.0 * x])
        acc = grav + rot
        for a in otherAccs:
            acc = acc + a
        return vf.stack([v, acc] + list(otherEOMs))

    def GenLissajousImpl(self, Lpt, xnd, znd, phideg, psideg, nplanrev,
                         npo, t0=0.0):
        """Linearized Lissajous initial guess about a collinear point
        (reference `Astro/Extensions/CR3BPFrame.py:97`): in-plane frequency
        s and amplitude ratio from the EOM Jacobian at the point, vertical
        frequency from Ozz; states generated vectorized over the time grid.
        """
        args = Arguments(6)
        func = self.CR3BPEOMs(args.head(3), args.tail(3))
        X = np.zeros(6)
        X[0:3] = Lpt
        J = func.jacobian(X)
        Oxx, Oyy, Ozz = J[3, 0], J[4, 1], J[5, 2]
        b1 = 2.0 - (Oxx + Oyy) / 2.0
        b2sq = -Oxx * Oyy
        s = np.sqrt(b1 + np.sqrt(b1 * b1 + b2sq))
        b3 = (s * s + Oxx) / (2.0 * s)
        pp = 2.0 * np.pi / s
        nu = np.sqrt(abs(Ozz))
        phi = np.deg2rad(phideg)
        psi = np.deg2rad(psideg)
        ynd = xnd * b3
        ti = np.linspace(0.0, nplanrev * pp, int(npo))
        st = np.zeros((int(npo), 7))
        st[:, 0] = Lpt[0] - (ynd / b3) * np.cos(s * ti + phi)
        st[:, 1] = Lpt[1] + ynd * np.sin(s * ti + phi)
        st[:, 2] = Lpt[2] + znd * np.sin(nu * ti + psi)
        st[:, 3] = (ynd / b3) * s * np.sin(s * ti + phi)
        st[:, 4] = ynd * s * np.cos(s * ti + phi)
        st[:, 5] = znd * nu * np.cos(nu * ti + psi)
        st[:, 6] = t0 + ti
        return [st[i] for i in range(st.shape[0])]

    def GenL1Lissajous(self, xnd, znd, phideg, psideg, nplanrev, npo,
                       t0=0.0):
        return self.GenLissajousImpl(self.L1, xnd, znd, phideg, psideg,
                                     nplanrev, npo, t0)

    def GenL2Lissajous(self, xnd, znd, phideg, psideg, nplanrev, npo,
                       t0=0.0):
        return self.GenLissajousImpl(self.L2, xnd, znd, phideg, psideg,
                                     nplanrev, npo, t0)

    def JacobiConstant(self, state):
        """C = 2U - v^2 for a state row [r, v, ...]."""
        mu = self.mu
        r = np.asarray(state[:3])
        v = np.asarray(state[3:6])
        r1 = np.linalg.norm(r - self.P1)
        r2 = np.linalg.norm(r - self.P2)
        U = 0.5 * (r[0] ** 2 + r[1] ** 2) + (1 - mu) / r1 + mu / r2
        return 2 * U - v @ v


class MEETwoBodyFrame(TwoBodyFrame):
    """Modified equinoctial elements frame (reference MEETwoBodyFrame /
    `src/Astro/MEEDynamics.h`): state [p, f, g, h, k, L]."""

    def MEEDynamics(self, mee, accRTN):
        """EOMs with perturbing acceleration in the RTN (radial, transverse,
        normal) frame."""
        p, f, g, h, k, L = mee.tolist()
        sinL, cosL = vf.sin(L), vf.cos(L)
        w = 1.0 + f * cosL + g * sinL
        s2 = 1.0 + h * h + k * k
        sqp = vf.sqrt(p)
        ar, at, an = accRTN.tolist()
        pdot = 2.0 * (p / w) * sqp * at
        fdot = sqp * (ar * sinL + ((w + 1.0) * cosL + f) * at / w
                      - (h * sinL - k * cosL) * g * an / w)
        gdot = sqp * (-ar * cosL + ((w + 1.0) * sinL + g) * at / w
                      + (h * sinL - k * cosL) * f * an / w)
        hdot = sqp * s2 * an * cosL / (2.0 * w)
        kdot = sqp * s2 * an * sinL / (2.0 * w)
        Ldot = sqp * (w / p) ** 2 + sqp * (h * sinL - k * cosL) * an / w
        return vf.stack([pdot, fdot, gdot, hdot, kdot, Ldot])
