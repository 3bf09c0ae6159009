"""CartPole swing-up (reference `examples/CartPole.py`): minimum-effort
trajectory with runtime mass-matrix inversion."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class CartPole(oc.ODEBase):
    def __init__(self, l, m1, m2, g):
        XtU = oc.ODEArguments(4, 1)
        x, theta, xdot, thetadot = XtU.XVec().tolist()
        F = XtU.UVar(0)
        Q = vf.stack([-g * vf.sin(theta),
                      F + m2 * l * vf.sin(theta) * thetadot ** 2])
        M = vf.RowMatrix(vf.stack(vf.cos(theta), l, m1 + m2,
                                  m2 * l * vf.cos(theta)), 2, 2)
        super().__init__(vf.stack([xdot, thetadot, M.inverse() * Q]), 4, 1)


if __name__ == "__main__":
    m1, m2, l, g = 1, .3, .5, 9.81
    Fmax, xmax, tf, xf = 20, 2, 2, 1
    ts = np.linspace(0, tf, 100)
    IG = [[xf * t / tf, np.pi * t / tf, 0, 0, t, .0] for t in ts]

    ode = CartPole(l, m1, m2, g)
    phase = ode.phase("LGL5", IG, 64)
    phase.addBoundaryValue("First", range(0, 5), [0, 0, 0, 0, 0])
    phase.addBoundaryValue("Last", range(0, 5), [xf, np.pi, 0, 0, tf])
    phase.addLUVarBound("Path", 5, -Fmax, Fmax)
    phase.addLUVarBound("Path", 0, -xmax, xmax)
    phase.addIntegralObjective(Args(1)[0] ** 2, [5])
    phase.optimizer.set_PrintLevel(1)
    phase.optimize()

    print("objective:", phase.optimizer.LastObjVal)
    print("total time:", phase.optimizer.LastTotalTime, "s")
    print("func time :", phase.optimizer.LastFuncTime, "s")
    print("KKT time  :", phase.optimizer.LastKKTTime, "s")
