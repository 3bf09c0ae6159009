"""Supersonic minimum time to climb, named-variable (Vgroups) interface
(reference `examples/UpdatedInterface/MinimumTimeToClimb.py`): named
states/controls, make_input/make_units, named bounds, adaptive mesh.
Published minimum climb time ~324.98 s."""

import numpy as np


import asset_asrl_torch as ast
from ..MinimumTimeToClimbTables import (ClalphaTab, etaTab, CD0Tab, rhoTab,
                                        sosTab, ThrustTab)

vf = ast.VectorFunctions
oc = ast.OptimalControl

g0 = 9.80665
Lstar, Tstar, Mstar = 10000, 250.0, 19050.864
Astar = Lstar / Tstar ** 2
Vstar = Lstar / Tstar
Rhostar = Mstar / Lstar ** 3
Mustar = (Lstar ** 3) / (Tstar ** 2)
Fstar = Astar * Mstar
mu = 3.986012e14 / Mustar
Re = 6378145 / Lstar
S = 49.2386 / (Lstar ** 2)
vexhaust = 1600 * g0 / Vstar


class AirPlane(oc.ODEBase):
    def __init__(self):
        XtU = oc.ODEArguments(4, 1)
        h, v, fpa, mass = XtU.XVec().tolist()
        alpha = XtU.UVar(0)
        rho = rhoTab(h * Lstar) / Rhostar
        sos = sosTab(h * Lstar) / Vstar
        Mach = v / sos
        CD = CD0Tab(Mach) + etaTab(Mach) * ClalphaTab(Mach) * (alpha ** 2)
        CL = ClalphaTab(Mach) * alpha
        Thrust = ThrustTab(Mach, h * Lstar) / Fstar
        q = 0.5 * rho * (v ** 2)
        D, L = q * S * CD, q * S * CL
        r = h + Re
        hdot = v * vf.sin(fpa)
        vdot = (Thrust * vf.cos(alpha) - D) / mass \
            - mu * vf.sin(fpa) / (r ** 2)
        fpadot = (Thrust * vf.sin(alpha) + L) / (mass * v) \
            + vf.cos(fpa) * (v / r - mu / (v * (r ** 2)))
        mdot = -Thrust / vexhaust
        Vgroups = {("h", "altitude"): h, ("v", "speed"): v,
                   ("fpa", "gamma"): fpa, ("mass", "m"): mass,
                   ("t", "time"): XtU.TVar(), ("alpha", "aoa"): alpha}
        super().__init__(vf.stack([hdot, vdot, fpadot, mdot]), 4, 1,
                         Vgroups=Vgroups)


def solve(nsegs=50, adaptive=False, print_level=1):
    ht0, htf = .010 / Lstar, 19994.88 / Lstar
    vt0, vtf = 129.314 / Vstar, 295.092 / Vstar
    mass0 = 19050.864 / Mstar

    ode = AirPlane()
    X0 = ode.make_input(h=ht0, v=vt0, fpa=0, mass=mass0, t=0)
    Xf = ode.make_input(h=htf, v=vtf, fpa=0, mass=mass0, t=200 / Tstar)
    Traj = [np.asarray(X0) * (1 - t) + np.asarray(Xf) * t
            for t in np.linspace(0, 1, 100)]

    phase = ode.phase("LGL5", Traj, nsegs)
    phase.setControlMode("HighestOrderSpline")
    phase.addBoundaryValue("First", ["h", "v", "fpa", "mass", "t"],
                           [ht0, vt0, 0, mass0, 0])
    phase.addLUVarBound("Path", "h", 0, 21000.0 / Lstar)
    phase.addLUVarBound("Path", "v", 5 / Vstar, 600 / Vstar)
    phase.addLUVarBound("Path", "fpa", np.deg2rad(-20), np.deg2rad(40))
    phase.addLowerVarBound("Last", "mass", 16500 / Mstar)
    phase.addLUVarBound("Path", "alpha", -np.pi / 4, np.pi / 4)
    phase.addBoundaryValue("Last", ["h", "v", "fpa"], [htf, vtf, 0])
    phase.addDeltaTimeObjective(1.0)
    if adaptive:
        phase.setAdaptiveMesh(True)
        phase.setMeshTol(1.0e-7)
    phase.optimizer.PrintLevel = print_level
    flag = phase.optimize()
    return phase, flag


if __name__ == "__main__":
    phase, flag = solve()
    Traj = phase.returnTraj()
    print("Minimum Time to Climb: {0:.2f}s".format(Traj[-1][4] * Tstar))
