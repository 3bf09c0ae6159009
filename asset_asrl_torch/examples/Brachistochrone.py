"""Brachistochrone (reference `examples/Brachistochrone.py`): runs verbatim
against asset_asrl_torch's namespace-compatible API."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class Brachistochrone(oc.ODEBase):
    def __init__(self, g):
        XtU = oc.ODEArguments(3, 1)
        x, y, v = XtU.XVec().tolist()
        theta = XtU.UVar(0)
        xdot = vf.sin(theta) * v
        ydot = -1.0 * vf.cos(theta) * v
        vdot = g * vf.cos(theta)
        super().__init__(vf.stack([xdot, ydot, vdot]), 3, 1)


if __name__ == "__main__":
    g = 9.81
    ode = Brachistochrone(g)
    x0, y0, v0, theta0 = 0, 10, 0, 1.0
    xf, yf, tf = 10, 5, 1
    ts = np.linspace(0, tf, 100)
    Xs = [[x0 + (xf - x0) * t / tf, y0 + (yf - y0) * t / tf,
           g * t * np.cos(theta0), t, theta0] for t in ts]

    phase = ode.phase("LGL3", Xs, 32)
    phase.addBoundaryValue("Front", range(0, 4), [x0, y0, v0, 0])
    phase.addLUVarBound("Path", 4, -0.1, 2.00)
    phase.addBoundaryValue("Back", [0, 1], [xf, yf])
    phase.addDeltaTimeObjective(1.0)
    phase.optimizer.PrintLevel = 1
    phase.optimize()

    Traj = phase.returnTraj()
    print("transfer time:", Traj[-1][3])
    try:
        import matplotlib.pyplot as plt
        TT = np.array(Traj).T
        plt.plot(TT[0], TT[1]); plt.xlabel("x"); plt.ylabel("y")
        plt.grid(True); plt.show()
    except ImportError:
        pass
