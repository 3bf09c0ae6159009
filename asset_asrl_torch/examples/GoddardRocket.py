"""Goddard rocket maximum-altitude ascent (reference
`examples/GoddardRocket.py`), both as a single phase and as the 3-phase
formulation with the singular-arc path constraint."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

g0, Lstar, Tstar, Mstar = 32.2, 10000.0, 60.0, 1
Vstar = Lstar / Tstar
Fstar = Mstar * Lstar / Tstar ** 2
Astar = Lstar / Tstar ** 2
Rhostar = Mstar / Lstar ** 3
sigmastar = Mstar / Lstar
rho0 = .002378 / Rhostar
h_ref = 23800 / Lstar
g = g0 / Astar
Tmag = 200 / Fstar
c = 1580.94 / Vstar
sigma = 5.4915e-5 / sigmastar
m0, mf = 3, 1


class GoddardRocket(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(3, 1)
        h, v, m = args.XVec().tolist()
        u = args.UVar(0)
        vdot = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) / m - g
        super().__init__(vf.stack(v, vdot, -u * Tmag / c), 3, 1)


def single_phase(ode, TrajIG):
    phase = ode.phase("LGL3", TrajIG, 96)
    phase.addBoundaryValue("Front", range(0, 4), TrajIG[0][0:4])
    phase.addLUVarBound("Path", 4, 0.0, 1.0, 1.0)
    phase.addValueObjective("Back", 0, -1.0)
    phase.addBoundaryValue("Back", [1, 2], [0, mf])
    phase.optimizer.PrintLevel = 1
    phase.optimize()
    return phase.returnTraj()


def multi_phase(ode, TrajIG):
    def PathCon():
        h, v, m, u = Args(4).tolist()
        t1 = (u * Tmag - sigma * (v ** 2) * vf.exp(-h / h_ref)) - g * m
        t2 = (m * g / (1 + 4 * (c / v) + 2 * (c / v) ** 2)) * (
            c * c * (1 + v / c) / (h_ref * g) - 1.0 - 2.0 * c / v)
        return t1 - t2

    n = len(TrajIG) // 3
    phase1 = ode.phase("LGL3", TrajIG[0:n], 24)
    phase1.addBoundaryValue("Front", range(0, 4), TrajIG[0][0:4])
    phase1.addBoundaryValue("Path", [4], [1])          # full throttle
    phase2 = ode.phase("LGL3", TrajIG[n:2 * n], 24)    # singular arc
    phase2.setControlMode("NoSpline")
    phase2.addLUVarBound("Path", 4, 0.0, 1.0, 1.0)
    phase2.addEqualCon("Path", PathCon(), [0, 1, 2, 4])
    phase3 = ode.phase("LGL3", TrajIG[2 * n:-1], 24)   # coast
    phase3.addBoundaryValue("Path", [4], [0])
    phase3.addBoundaryValue("Back", [1, 2], [0, mf])
    phase3.addValueObjective("Back", 0, -1.0)

    ocp = oc.OptimalControlProblem()
    ocp.addPhase(phase1); ocp.addPhase(phase2); ocp.addPhase(phase3)
    ocp.addForwardLinkEqualCon(phase1, phase3, range(0, 4))
    for p in (phase1, phase2, phase3):
        p.addLowerDeltaTimeBound(0)
    ocp.optimizer.PrintLevel = 1
    ocp.optimize()
    return (phase1.returnTraj() + phase2.returnTraj()
            + phase3.returnTraj())


if __name__ == "__main__":
    ode = GoddardRocket()
    # burn-until-empty initial guess from the integrator + stop event
    ulaw = vf.ifelse(Args(1)[0] > mf, 1, 0)
    integ = ode.integrator(.01, ulaw, [2])
    X0 = np.zeros(5)
    X0[2] = m0
    X0[4] = 1
    TrajIG = integ.integrate_dense(X0, 60 / Tstar, 500, lambda x: x[1] < 0)

    T1 = single_phase(ode, TrajIG)
    T2 = multi_phase(ode, TrajIG)
    print("single-phase final altitude (ft):", T1[-1][0] * Lstar)
    print("3-phase final altitude (ft):    ", T2[-1][0] * Lstar)

    try:
        import matplotlib.pyplot as plt
        for T, lab in ((T1, "single phase"), (T2, "3 phase")):
            TT = np.array(T).T
            plt.plot(TT[3] * Tstar, TT[0] * Lstar, label=lab)
        plt.xlabel("t (s)"); plt.ylabel("h (ft)")
        plt.grid(True); plt.legend(); plt.show()
    except ImportError:
        pass
