"""Goddard rocket via the Vgroups named-variable interface (reference
`examples/UpdatedInterface/GoddardRocket.py`): named boundary values,
named units via make_units, autoscaling, and the 3-phase singular-arc
formulation with named forward links."""

import numpy as np
import asset_asrl_torch as ast
import asset_asrl_torch.VectorFunctions as vf
import asset_asrl_torch.OptimalControl as oc
from asset_asrl_torch.VectorFunctions import Arguments as Args

g0, W = 32.2, 203000
Lstar, Tstar, Mstar = 10000.0, 60.0, 1
Vstar = Lstar / Tstar
rho0, h_ref, g = .002378, 23800, g0
Tmag, c, sigma = 200, 1580.94, 5.4915e-5
m0, mf = 3, 1


class GoddardRocket(oc.ODEBase):
    def __init__(self, sigma, c, h_ref, Tmag, g):
        XtU = oc.ODEArguments(3, 1)
        h, v, m = XtU.XVec().tolist()
        u = XtU.UVar(0)
        hdot = v
        vdot = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) / m - g
        mdot = -u * Tmag / c
        ode = vf.stack(hdot, vdot, mdot)
        Vgroups = {("h", "altitude"): h, ("v", "velocity"): v,
                   ("m", "mass"): m, ("t", "time"): XtU.TVar(), "u": u}
        super().__init__(ode, 3, 1, Vgroups=Vgroups)


def PathCon(sigma, c, h_ref, Tmag, g):
    h, v, m, u = Args(4).tolist()
    t1 = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) - g * m
    t2 = (m * g / (1 + 4 * (c / v) + 2 * (c / v) ** 2)) * (
        c * c * (1 + v / c) / (h_ref * g) - 1.0 - 2.0 * c / v)
    return t1 - t2


def run(print_level=1):
    def Ulaw():
        m = Args(1)[0]
        return vf.ifelse(m > mf, 1, 0)

    def StopFunc(x):
        return x[1] < 0

    ode = GoddardRocket(sigma, c, h_ref, Tmag, g)
    units = ode.make_units(h=Lstar, v=Vstar, m=Mstar, t=Tstar)
    integ = ode.integrator(.01, Ulaw(), "m")
    X0 = ode.make_input(h=0, v=0, m=m0, u=1)
    TrajIG = integ.integrate_dense(X0, 60, 1000, StopFunc)

    # single-phase (singular arc)
    phase = ode.phase("LGL3", TrajIG, 96)
    phase.setAutoScaling(True)
    phase.setUnits(units)
    phase.addBoundaryValue("Front", ["h", "v", "m", "t"], TrajIG[0][0:4])
    phase.addLUVarBound("Path", "u", 0.0, 1.0, 1.0)
    phase.addValueObjective("Back", "h", -1.0)
    phase.addBoundaryValue("Back", ["v", "m"], [0, mf])
    phase.optimizer.PrintLevel = print_level
    phase.optimize()
    Traj = phase.returnTraj()

    # 3-phase formulation: control defined by the singular-arc path con
    n = int(len(TrajIG) / 3)
    phase1 = ode.phase("LGL3", TrajIG[0:n], 24)
    phase1.addBoundaryValue("Front", ["h", "v", "m", "t"], TrajIG[0][0:4])
    phase1.addBoundaryValue("Path", "u", 1.0)
    phase2 = ode.phase("LGL3", TrajIG[n:2 * n], 24)
    phase2.setControlMode("NoSpline")
    phase2.addLUVarBound("Path", "u", 0.0, 1.0, 1.0)
    phase2.addEqualCon("Path", PathCon(sigma, c, h_ref, Tmag, g),
                       ["h", "v", "m", "u"])
    phase3 = ode.phase("LGL3", TrajIG[2 * n:-1], 24)
    phase3.addBoundaryValue("Path", "u", 0)
    phase3.addBoundaryValue("Back", ["v", "m"], [0, mf])
    phase3.addValueObjective("Back", "h", -1.0)

    ocp = oc.OptimalControlProblem()
    ocp.addPhase(phase1)
    ocp.addPhase(phase2)
    ocp.addPhase(phase3)
    ocp.addForwardLinkEqualCon(phase1, phase3, ["h", "v", "m", "t"])
    for p in (phase1, phase2, phase3):
        p.addLowerDeltaTimeBound(0)
        p.setUnits(units)
    ocp.setAutoScaling(True, True)
    ocp.optimizer.PrintLevel = print_level
    ocp.optimize()
    Traj2 = phase1.returnTraj() + phase2.returnTraj() + phase3.returnTraj()
    return Traj, Traj2


if __name__ == "__main__":
    Traj, Traj2 = run()
    print(f"single-phase  final altitude: {Traj[-1][0]:.2f} ft")
    print(f"three-phase   final altitude: {Traj2[-1][0]:.2f} ft")
