"""Thruster / solar-sail acceleration models.

Reference: `asset_asrl/Astro/Extensions/ThrusterModels.py` +
`src/Astro/ThrusterModels.h` (ideal/non-ideal sail accel models).

Port of `asset_asrl_tpu/Astro/ThrusterModels.py`.
"""

from __future__ import annotations

import numpy as np

from .. import VectorFunctions as vf
from . import Constants as c


class LowThrustAcc:
    """Constant-magnitude throttleable low-thrust acceleration.

    NonDim_LTacc: canonical acceleration magnitude; control is the 3-vector
    throttle direction (|u| <= 1)."""

    def __init__(self, NonDim_LTacc=None, LTacc=None, M=None):
        if NonDim_LTacc is not None:
            self.NDacc = float(NonDim_LTacc)
        elif LTacc is not None and M is not None:
            self.NDacc = float(LTacc) / float(M)
        else:
            self.NDacc = 0.02

    def acc(self, u):
        """Acceleration expression from throttle-direction control u."""
        return u * self.NDacc

    def ThrustExpr(self, u, astar=1.0):
        return u * (self.NDacc / astar)


class CSIThruster:
    """Constant specific impulse thruster: thrust F, mass flow F/(Isp g0).

    State must carry mass; control is throttle direction vector."""

    def __init__(self, F, Isp, M):
        self.F = float(F)       # N
        self.Isp = float(Isp)   # s
        self.M = float(M)       # kg reference mass
        self.mdot = self.F / (self.Isp * c.g0)

    def nondim(self, astar, tstar):
        """(acc_canonical_per_unit_mass, mdot_canonical)."""
        return (self.F / (self.M * astar), self.mdot * tstar / self.M)


class SolarSail:
    """Ideal (and McInnes non-ideal) solar sail acceleration.

    beta: lightness number (ratio of sail acceleration to solar gravity).
    Ideal model: a = beta*mu/r^2 * cos^2(alpha) * n_hat.
    """

    def __init__(self, beta=0.02, Ideal=True, rbar=0.91, sbar=0.89,
                 ef=0.025, eb=0.55, Bf=0.79, Bb=0.55):
        self.beta = float(beta)
        self.Ideal = bool(Ideal)
        self.rbar, self.sbar = rbar, sbar
        self.ef, self.eb, self.Bf, self.Bb = ef, eb, Bf, Bb
        if not Ideal:
            # McInnes optical force coefficients
            self.n1 = 1 + rbar * sbar
            self.n2 = Bf * (1 - sbar) * rbar + (1 - rbar) * (
                ef * Bf - eb * Bb) / (ef + eb)
            self.t1 = 1 - sbar * rbar

    def acc_ideal(self, r, n, mu=1.0):
        """Ideal sail acceleration expression: r position func, n sail
        normal func (unit), canonical mu."""
        rhat = r.normalized()
        ndotr = n.dot(rhat)
        return n * (self.beta * mu * ndotr * ndotr) * r.inverse_norm() \
            * r.inverse_norm()
