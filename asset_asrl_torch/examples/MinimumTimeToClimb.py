"""Supersonic minimum time to climb (Bryson 1969; ICLOCS2 SI reformulation).

Reference `examples/MinimumTimeToClimb.py`: an F-4 climbs from sea level to
~20 km, dynamics closed over differentiable 1-D/2-D aero/thrust tables.
Published solutions put the minimum climb time near 324.98 s.
"""

import numpy as np


import asset_asrl_torch as ast
from .MinimumTimeToClimbTables import (ClalphaTab, etaTab, CD0Tab, rhoTab,
                                       sosTab, ThrustTab)

vf = ast.VectorFunctions
oc = ast.OptimalControl

g0 = 9.80665
Lstar = 10000
Tstar = 250.0
Mstar = 19050.864

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
        # altitude, velocity, flight-path angle, mass; control = AoA
        h, v, fpa, mass = XtU.XVec().tolist()
        alpha = XtU.UVar(0)

        rho = rhoTab(h * Lstar) / Rhostar
        sos = sosTab(h * Lstar) / Vstar
        Mach = v / sos
        CD0 = CD0Tab(Mach)
        Clalpha = ClalphaTab(Mach)
        eta = etaTab(Mach)
        Thrust = ThrustTab(Mach, h * Lstar) / Fstar

        CD = CD0 + eta * Clalpha * (alpha ** 2)
        CL = Clalpha * alpha
        q = 0.5 * rho * (v ** 2)
        D = q * S * CD
        L = q * S * CL
        r = h + Re

        hdot = v * vf.sin(fpa)
        vdot = (Thrust * vf.cos(alpha) - D) / mass \
            - mu * vf.sin(fpa) / (r ** 2)
        fpadot = (Thrust * vf.sin(alpha) + L) / (mass * v) \
            + vf.cos(fpa) * (v / r - mu / (v * (r ** 2)))
        mdot = -Thrust / vexhaust
        super().__init__(vf.stack([hdot, vdot, fpadot, mdot]), 4, 1)


def solve(nsegs=50, adaptive=False):
    ht0, htf = .010 / Lstar, 19994.88 / Lstar
    vt0, vtf = 129.314 / Vstar, 295.092 / Vstar
    fpat0 = fpatf = 0
    mass0 = 19050.864 / Mstar

    hmin, hmax = 0, 21000.0 / Lstar
    vmin, vmax = 5 / Vstar, 600 / Vstar
    fpamin, fpamax = -20 * np.pi / 180, 40 * np.pi / 180
    massmin = 16500 / Mstar
    alphamin, alphamax = -np.pi / 4, np.pi / 4
    tfig = 200 / Tstar

    XtU0 = np.array([ht0, vt0, fpat0, mass0, 0, 0])
    XtUf = np.array([htf, vtf, fpatf, mass0, tfig, 0])
    Traj = [XtU0 * (1 - t) + XtUf * t for t in np.linspace(0, 1, 100)]

    ode = AirPlane()
    phase = ode.phase("LGL5", Traj, nsegs)
    phase.setControlMode("HighestOrderSpline")
    phase.addBoundaryValue("First", range(0, 5), [ht0, vt0, fpat0, mass0, 0])
    phase.addLUVarBound("Path", 0, hmin, hmax)
    phase.addLUVarBound("Path", 1, vmin, vmax)
    phase.addLUVarBound("Path", 2, fpamin, fpamax)
    phase.addLowerVarBound("Last", 3, massmin)
    phase.addLUVarBound("Path", 5, alphamin, alphamax)
    phase.addBoundaryValue("Last", range(0, 3), [htf, vtf, fpatf])
    phase.addDeltaTimeObjective(1.0)
    if adaptive:
        phase.setAdaptiveMesh(True)
        phase.setMeshTol(1.0e-7)
    phase.optimizer.PrintLevel = 1
    flag = phase.optimize()
    return phase, flag


if __name__ == "__main__":
    phase, flag = solve()
    Traj = phase.returnTraj()
    print("Minimum Time to Climb: {0:.2f}s".format(Traj[-1][4] * Tstar))
