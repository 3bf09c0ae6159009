"""Dynamical model zoo: ballistic + low-thrust + sail ODEs.

Reference: `asset_asrl/Astro/AstroModels.py:23-262` (TwoBody/CR3BP/MEE x
ballistic, low-thrust, CSI, solar-sail classes) backed by
`src/Astro/{KeplerModel,CR3BPModel,MEEDynamics}.h`.

Port of `asset_asrl_tpu/Astro/AstroModels.py`.
"""

from __future__ import annotations

import numpy as np

from .. import VectorFunctions as vf
from ..OptimalControl import ODEArguments, ODEBase
from . import Constants as c
from .Frames import TwoBodyFrame, CR3BPFrame, MEETwoBodyFrame
from .ThrusterModels import LowThrustAcc, CSIThruster, SolarSail

Args = vf.Arguments

__all__ = ["TwoBody", "CR3BP", "TwoBody_LT", "CR3BP_LT", "MEETwoBody_LT",
           "MEETwoBody_CSI", "Kepler", "TwoBody_SolarSail",
           "CR3BP_SolarSail"]


class TwoBody(ODEBase, TwoBodyFrame):
    """Canonical two-body ballistic dynamics (reference
    `src/Astro/KeplerModel.h:10-36`)."""

    def __init__(self, P1mu, lstar):
        TwoBodyFrame.__init__(self, P1mu, lstar)
        args = ODEArguments(6, 0)
        r = args.head3()
        v = args.segment3(3)
        ODEBase.__init__(self, self.TwoBodyEOMs(r, v), 6)


Kepler = TwoBody  # reference alias (ast.Astro.Kepler)


class CR3BP(ODEBase, CR3BPFrame):
    """Circular restricted three-body dynamics (reference
    `src/Astro/CR3BPModel.h:9`)."""

    def __init__(self, P1mu, P2mu, lstar):
        CR3BPFrame.__init__(self, P1mu, P2mu, lstar)
        args = ODEArguments(6, 0)
        r = args.XVec().head3()
        v = args.XVec().tail3()
        ODEBase.__init__(self, self.CR3BPEOMs(r, v), 6)


class TwoBody_LT(ODEBase, TwoBodyFrame):
    """Two-body + throttleable low-thrust acceleration; control = 3-vector
    throttle direction."""

    def __init__(self, P1mu, lstar, thruster=None):
        TwoBodyFrame.__init__(self, P1mu, lstar)
        self.thruster = thruster or LowThrustAcc()
        args = ODEArguments(6, 3)
        r = args.XVec().head3()
        v = args.XVec().tail3()
        u = args.UVec()
        acc = u * self.thruster.NDacc
        ODEBase.__init__(self, self.TwoBodyEOMs(r, v, otherAccs=[acc]), 6, 3)


class CR3BP_LT(ODEBase, CR3BPFrame):

    def __init__(self, P1mu, P2mu, lstar, thruster=None):
        CR3BPFrame.__init__(self, P1mu, P2mu, lstar)
        self.thruster = thruster or LowThrustAcc()
        args = ODEArguments(6, 3)
        r = args.XVec().head3()
        v = args.XVec().tail3()
        u = args.UVec()
        acc = u * self.thruster.NDacc
        ODEBase.__init__(self, self.CR3BPEOMs(r, v, otherAccs=[acc]), 6, 3)


class MEETwoBody_LT(ODEBase, MEETwoBodyFrame):
    """Modified-equinoctial low thrust: state [p,f,g,h,k,L], control = RTN
    throttle direction (reference `MEEDynamics.h:7`)."""

    def __init__(self, P1mu, lstar, thruster=None):
        TwoBodyFrame.__init__(self, P1mu, lstar)
        self.thruster = thruster or LowThrustAcc()
        args = ODEArguments(6, 3)
        mee = args.XVec()
        u = args.UVec()
        ODEBase.__init__(
            self, self.MEEDynamics(mee, u * self.thruster.NDacc), 6, 3)


class MEETwoBody_CSI(ODEBase, MEETwoBodyFrame):
    """MEE + constant-specific-impulse thruster with mass state:
    state [p,f,g,h,k,L,m], control = RTN throttle direction."""

    def __init__(self, P1mu, lstar, CSIthrust: CSIThruster):
        TwoBodyFrame.__init__(self, P1mu, lstar)
        self.thruster = CSIthrust
        acc_c, mdot_c = CSIthrust.nondim(self.astar, self.tstar)
        args = ODEArguments(7, 3)
        mee = args.XVec().head(6)
        m = args.XVar(6)
        u = args.UVec()
        accRTN = u * acc_c / m
        meedot = self.MEEDynamics(mee, accRTN)
        mdot = -u.norm() * mdot_c
        ODEBase.__init__(self, vf.stack([meedot, mdot]), 7, 3)


class TwoBody_SolarSail(ODEBase, TwoBodyFrame):
    """Ideal solar sail about one body; control = sail normal (unit)."""

    def __init__(self, P1mu=c.MuSun, lstar=c.AU, SailModel=None):
        TwoBodyFrame.__init__(self, P1mu, lstar)
        self.sail = SailModel or SolarSail(.02, True)
        args = ODEArguments(6, 3)
        r = args.XVec().head3()
        v = args.XVec().tail3()
        n = args.UVec()
        acc = self.sail.acc_ideal(r, n, mu=1.0)
        ODEBase.__init__(self, self.TwoBodyEOMs(r, v, otherAccs=[acc]), 6, 3)


class CR3BP_SolarSail(ODEBase, CR3BPFrame):
    """Sun-planet CR3BP with ideal sail (sun at P1); control = sail normal."""

    def __init__(self, mu1=c.MuSun, mu2=c.MuEarth, lstar=c.AU,
                 SailModel=None):
        CR3BPFrame.__init__(self, mu1, mu2, lstar)
        self.sail = SailModel or SolarSail(.02, True)
        args = ODEArguments(6, 3)
        r = args.XVec().head3()
        v = args.XVec().tail3()
        n = args.UVec()
        r1 = r - np.array([-self.mu, 0, 0])
        acc = self.sail.acc_ideal(r1, n, mu=1.0 - self.mu)
        ODEBase.__init__(self, self.CR3BPEOMs(r, v, otherAccs=[acc]), 6, 3)
