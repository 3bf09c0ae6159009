"""NBodyFrame: ephemeris-driven P1-centered inertial frame with third-body
perturbations.

Port of `asset_asrl_tpu/Astro/Extensions/NBodyFrame.py` (reference
`asset_asrl/Astro/Extensions/NBodyFrame.py:23-183`).  The frame is
centered on P1 (whose own inertial acceleration is applied as a frame
correction, CalcFrameData); additional bodies contribute third-body gravity
through interp-table position functions.

Design note: the reference pulls every ephemeris from SPICE
(spiceypy).  Here the ephemeris source is pluggable:
* a SPICE kernel set when spiceypy is importable (via `..SpiceRead`),
* precomputed trajectories passed directly (`P1Data=...`,
  `AddBodyTable(name, traj, mu)`),
* or the analytic `KeplerianEphemeris` generator (two-body orbits about the
  system barycenter) so self-contained tests/examples need no kernels.
"""

from __future__ import annotations

import numpy as np

from ... import VectorFunctions as vf
from ...OptimalControl.interp_table import LGLInterpTable, InterpFunction

from ..Frames import TwoBodyFrame
from .. import Constants as c

Args = vf.Arguments

BProps = getattr(c, "SpiceBodyProps", {})


def KeplerianEphemeris(mu, elements, t0, tf, N, phase0=0.0):
    """Analytic two-body ephemeris: N+1 rows [r, v, t] (nondimensional) of
    an orbit with classical `elements` = [a, e, i, RAAN, argp, M0] about a
    center with gravitational parameter `mu` (all nondimensional)."""
    from ..kepler import classic_to_cartesian, propagate_kepler
    X0 = classic_to_cartesian(np.asarray(elements, np.float64), mu)
    ts = np.linspace(t0, tf, int(N) + 1)
    XV = np.asarray(propagate_kepler(
        np.tile(np.asarray(X0, np.float64)[:6], (len(ts), 1)),
        ts - ts[0], mu))
    return [np.concatenate([XV[i, :6], [ts[i]]]) for i in range(len(ts))]


from .frame_kinematics import BodyRegistry


class NBodyFrame(TwoBodyFrame, BodyRegistry):

    def __init__(self, P1name, P1mu, Lstar, JD0, JDF, N=3000,
                 SpiceFrame="J2000", P1Data=None):
        TwoBodyFrame.__init__(self, P1mu, Lstar)
        self.P1name = P1name
        self.JD0 = JD0
        self.JDF = JDF
        self.SpiceFrame = SpiceFrame
        if P1Data is None:
            from ..SpiceRead import GetEphemTraj2
            P1Data = GetEphemTraj2(P1name, JD0, JDF, N, self.lstar,
                                   self.tstar, Frame=SpiceFrame)
        self.P1Data = [np.asarray(r, np.float64) for r in P1Data]
        self._init_body_registry()
        self.CalcFrameData()
        self.P1_J2 = False

    # ------------------------------------------------------------- times
    def JD_to_NDTime(self, JD):
        return (JD - self.JD0) * 24.0 * 3600.0 / self.tstar

    def NDTime_to_JD(self, ND):
        return self.JD0 + ND * self.tstar / (24.0 * 3600.0)

    # -------------------------------------------------------- transforms
    def NDInertial_to_Frame(self, Traj, axis=6):
        out = []
        for T in Traj:
            X = np.array(T, np.float64, copy=True)
            X[0:6] = X[0:6] - self.P1Table.Interpolate(X[axis])[0:6]
            out.append(X)
        return out

    def Frame_to_NDInertial(self, Traj, axis=6):
        out = []
        for T in Traj:
            X = np.array(T, np.float64, copy=True)
            X[0:6] = X[0:6] + self.P1Table.Interpolate(X[axis])[0:6]
            out.append(X)
        return out

    def NDInertial_to_Frame_Func(self):
        args = Args(7)
        t = args[6]
        XN = args.head(6) - self.P1Func.eval(t)
        return vf.stack([XN, t])

    def Frame_to_NDInertial_Func(self):
        args = Args(7)
        t = args[6]
        XN = args.head(6) + self.P1Func.eval(t)
        return vf.stack([XN, t])

    def Transform_Func(self, OtherFrame):
        FrameToND1 = self.Frame_to_NDInertial_Func()
        ND2ToFrame = OtherFrame.NDInertial_to_Frame_Func()
        xscale = self.lstar / OtherFrame.lstar
        vscale = self.vstar / OtherFrame.vstar
        toff = OtherFrame.JD_to_NDTime(self.NDTime_to_JD(0.0))
        tsc = self.tstar / OtherFrame.tstar
        args = Args(7)
        ND1toND2 = vf.stack([args.head3() * xscale,
                             args.segment3(3) * vscale,
                             args[6] * tsc + toff])
        return (ND2ToFrame.eval(ND1toND2)).eval(FrameToND1)

    # ------------------------------------------------------------- bodies
    def AddBodyTable(self, Name, Traj, mu, frame_relative=True):
        """Register a third body from a precomputed trajectory of rows
        [r(3), ..., t] in THIS frame (or ND inertial when
        frame_relative=False)."""
        rows = [np.asarray(r, np.float64) for r in Traj]
        if not frame_relative:
            rows = self.NDInertial_to_Frame(rows)
        self.register_body(Name, rows, mu / self.mustar)

    def GetSpiceBodyTraj(self, Name, N):
        from ..SpiceRead import GetEphemTraj2
        ITraj = GetEphemTraj2(Name, self.JD0, self.JDF, N, self.lstar,
                              self.tstar, Frame=self.SpiceFrame)
        return self.NDInertial_to_Frame(ITraj)

    def GetSpiceBodyTable(self, Name, N):
        return LGLInterpTable(6, self.GetSpiceBodyTraj(Name, N), N + 1)

    def AddSpiceBody(self, Name, mu=None, N=5000):
        if mu is None:
            mu = BProps[Name]["Mu"]
        self.AddBodyTable(Name, self.GetSpiceBodyTraj(Name, N), mu)

    def AddSpiceBodies(self, Names, N=5000):
        for Name in Names:
            self.AddSpiceBody(Name, N=N)

    def Add_P1_J2Effect(self, J2c=None, RadP1=None, pole=(0.0, 0.0, 1.0)):
        if J2c is None:
            J2c = BProps[self.P1name]["J2"]
        if RadP1 is None:
            RadP1 = BProps[self.P1name]["Radius"]
        self.P1_Rad = RadP1 / self.lstar
        self.P1_J2 = J2c
        self._p1_pole = np.asarray(pole, np.float64)

    # --------------------------------------------------------- frame data
    def CalcFrameData(self):
        """P1's inertial acceleration (the frame's non-inertiality
        correction) by `torch.func` AD of the smooth ephemeris interpolant
        (`frame_kinematics`), replacing the reference's finite-difference
        table pipeline."""
        from .frame_kinematics import (DifferentiableEphemeris,
                                       center_acceleration_samples)
        self.P1Table = LGLInterpTable(6, self.P1Data, len(self.P1Data))
        self.P1Func = InterpFunction(self.P1Table, range(0, 6))
        eph = DifferentiableEphemeris(self.P1Data)
        ts = np.asarray([r[6] for r in self.P1Data])
        negacc = center_acceleration_samples(eph, ts)
        P1AccD = [np.concatenate([negacc[i], [ts[i]]])
                  for i in range(len(ts))]
        self.P1AccTable = LGLInterpTable(3, P1AccD, len(P1AccD))
        self.P1AccFunc = InterpFunction(self.P1AccTable, range(0, 3))

    # --------------------------------------------------------------- EOMs
    def NBodyEOMs(self, r, v, t, otherAccs=[], otherEOMs=[],
                  ActiveAltBodies="All", Enable_J2=False,
                  Enable_P1_Acc=True):
        accs = list(otherAccs)
        Names = self.AltBodyNames if ActiveAltBodies == "All" \
            else ActiveAltBodies
        for Name in Names:
            rBody = self.AltBodyLocFuncs[Name].eval(t)
            muB = self.AltBodyMuVals[Name]
            accs.append((rBody - r).normalized_power3() * muB)
        if self.P1_J2 and Enable_J2:
            from ..J2 import J2Cartesian
            j2func = J2Cartesian(self.mu, self.P1_J2, self.P1_Rad)
            accs.append(j2func(vf.stack([r, r * 0.0 + self._p1_pole])))
        if Enable_P1_Acc:
            accs.append(self.P1AccFunc.eval(t))
        return self.TwoBodyEOMs(r, v, accs, otherEOMs)
