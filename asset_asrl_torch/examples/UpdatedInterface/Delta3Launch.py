"""Delta III 4-phase ascent to GTO, named-variable (Vgroups) interface
(reference `examples/UpdatedInterface/Delta3Launch.py`): named state
groups (R/V vectors, mass, thrust direction), named boundary values and
forward links, adaptive mesh.  Reference regression value 7529.75 kg."""

import numpy as np


import asset_asrl_torch as ast
from ..Delta3Launch import (RocketODE as _BaseODE, TargetOrbit, T_phase,
                            mdot_phase, tf_phase, m0_phase, mf_phase,
                            Lstar, Tstar, Mstar, Vstar, Re, We, mu)

vf = ast.VectorFunctions
oc = ast.OptimalControl


class RocketODE(_BaseODE):
    """The base dynamics with named variable groups."""

    def __init__(self, T, mdot):
        super().__init__(T, mdot)
        XtU = oc.ODEArguments(7, 3)
        self.add_Vgroups({("R", "position"): XtU.XVec().head3(),
                          ("V", "velocity"): XtU.XVec().segment3(3),
                          ("m", "mass"): XtU.XVar(6),
                          ("t", "time"): XtU.TVar(),
                          ("u", "thrustdir"): XtU.UVec()})


def build_ocp(nsegs=40, adaptive=True, print_level=1):
    at = 24361140 / Lstar
    et = .7308
    Ot = np.deg2rad(269.8)
    Wt = np.deg2rad(130.5)
    istart = np.deg2rad(28.5)

    y0 = np.zeros(6)
    y0[0:3] = np.array([np.cos(istart), 0, np.sin(istart)]) * Re
    y0[3:6] = -np.cross(y0[0:3], np.array([0, 0, We]))
    y0[3] += 0.00001 / Vstar
    yf = ast.Astro.classic_to_cartesian([at, et, istart, Ot, Wt, -.05], mu)

    ts = np.linspace(0, tf_phase[3], 1000)
    IGs = [[], [], [], []]
    bounds_t = [0] + tf_phase
    for t in ts:
        X = np.zeros(11)
        X[0:6] = y0 + (yf - y0) * (t / ts[-1])
        X[7] = t
        X[8:11] = [0, 1, 0]
        for ph in range(4):
            if bounds_t[ph] <= t < bounds_t[ph + 1] or \
                    (ph == 3 and t >= bounds_t[4]):
                frac = (t - bounds_t[ph]) / (bounds_t[ph + 1] - bounds_t[ph])
                X[6] = m0_phase[ph] + (mf_phase[ph] - m0_phase[ph]) * frac
                IGs[ph].append(X.copy())
                break

    odes = [RocketODE(T_phase[i], mdot_phase[i]) for i in range(4)]
    phases = []
    for i in range(4):
        p = odes[i].phase("LGL3", IGs[i], nsegs)
        p.setControlMode("HighestOrderSpline")
        p.addLUNormBound("Path", "u", .5, 1.5)
        if i == 0:
            p.addBoundaryValue("Front", ["R", "V", "m", "t"],
                               IGs[0][0][0:8])
            p.addLowerNormBound("Path", "R", Re * .999999)
        else:
            p.addLowerNormBound("Path", "R", Re)
            p.addBoundaryValue("Front", ["m"], [m0_phase[i]])
        if i < 3:
            p.addBoundaryValue("Back", ["t"], [tf_phase[i]])
        if adaptive:
            p.MeshTol = 1e-7
            p.MaxMeshIters = 4
            p.MeshErrorEstimator = "deboor"
        phases.append(p)

    phases[3].addUpperVarBound("Back", "t", tf_phase[3], 1.0)
    phases[3].addEqualCon("Back", TargetOrbit(at, et, istart, Ot, Wt),
                          ["R", "V"])
    phases[3].addValueObjective("Back", "m", -1.0)

    ocp = oc.OptimalControlProblem()
    for p in phases:
        ocp.addPhase(p)
    ocp.addForwardLinkEqualCon(phases[0], phases[3],
                               ["R", "V", "t", "u"])
    if adaptive:
        ocp.setAdaptiveMesh(True)
    ocp.optimizer.set_OptLSMode("L1")
    ocp.optimizer.set_SoeLSMode("L1")
    ocp.optimizer.set_MaxLSIters(2)
    ocp.optimizer.PrintLevel = print_level
    return ocp


if __name__ == "__main__":
    ocp = build_ocp()
    ocp.solve_optimize()
    mfinal = ocp.Phases[3].returnTraj()[-1][6] * Mstar
    print("final mass (kg):", mfinal, "(reference 7529.7499)")
