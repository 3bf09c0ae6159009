"""Planar polar low-thrust orbit raising r=1 -> r=4, time- and
mass-optimal (reference `examples/TopputtoLowThrust.py`, formulation from
Topputo & Zhang, Abstr. Appl. Anal. 2014:851720).  Initial guesses come
from integrating a guessed control with a stop-callable (r > RF)."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

RF = 4.0


class LTModel(oc.ODEBase):
    def __init__(self, amax):
        XtU = oc.ODEArguments(4, 2)
        r, theta, vr, vt = XtU.XVec().tolist()
        u, alpha = XtU.UVec().tolist()
        rdot = vr
        thetadot = vt / r
        vrdot = (vt ** 2) / r - 1 / (r ** 2) + amax * u * vf.sin(alpha)
        vtdot = -(vt * vr) / r + amax * u * vf.cos(alpha)
        super().__init__(vf.stack([rdot, thetadot, vrdot, vtdot]), 4, 2)


def run(nsegs=200, print_level=1):
    amax = .01
    ode = LTModel(amax)
    integ = ode.integrator(.01)
    VF = np.sqrt(1 / RF)

    IState = np.zeros(7)
    IState[0] = 1
    IState[3] = 1
    IState[5] = .99
    IState[6] = 0

    def RFunc(x):
        return x[0] > RF

    ToptIG = integ.integrate_dense(IState, 130, 1000, RFunc)
    IState[5] = .5
    MoptIG = integ.integrate_dense(IState, 160, 1000, RFunc)

    phase = ode.phase("LGL3", ToptIG, nsegs)
    phase.addBoundaryValue("Front", range(0, 5), IState[0:5])
    phase.addLUVarBound("Path", 5, 0.0001, 1, 100.0)
    phase.addLUVarBound("Path", 6, -2 * np.pi, 2 * np.pi, 1.0)
    phase.addBoundaryValue("Back", [0, 2, 3], [RF, 0, VF])
    phase.optimizer.set_PrintLevel(print_level)
    phase.optimizer.set_MaxAccIters(500)
    phase.optimizer.set_MaxIters(1000)
    phase.optimizer.set_BoundFraction(.995)
    phase.optimizer.deltaH = 1.0e-5

    phase.addDeltaTimeObjective(1 / 100)
    phase.solve_optimize_solve()
    TimeOptimal = phase.returnTraj()

    phase.removeStateObjective(0)
    phase.setTraj(MoptIG, nsegs)
    phase.addIntegralObjective(Args(1)[0] / 100, [5])
    phase.optimize_solve()
    phase.refineTrajManual(2 * nsegs)
    phase.optimize_solve()
    MassOptimal = phase.returnTraj()
    return TimeOptimal, MassOptimal


if __name__ == "__main__":
    TimeOptimal, MassOptimal = run()
    print(f"time-optimal tof  = {TimeOptimal[-1][4]:.4f}")
    mo = np.asarray(MassOptimal)
    eff = np.trapezoid(mo[:, 5], mo[:, 4])
    print(f"mass-optimal tof  = {mo[-1][4]:.4f}, integral u = {eff:.4f}")
