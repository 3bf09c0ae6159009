"""Minimum-time bicycle steering around a circular obstacle (reference
`examples/BikeObstacle.py`; problem from arXiv:2003.00142)."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class BikeODE(oc.ODEBase):
    def __init__(self, la, lb):
        args = oc.ODEArguments(4, 2)
        x, y, psi, v = args.XVec().tolist()
        acc, alpha = args.UVec().tolist()
        beta = vf.arctan((la / (la + lb)) * vf.tan(alpha))
        xdot = v * vf.cos(psi + beta)
        ydot = v * vf.sin(psi + beta)
        psidot = v * vf.sin(beta) / lb
        super().__init__(vf.stack(xdot, ydot, psidot, acc), 4, 2)


def ObstacleConstraint(xobs, yobs, obsrad, m):
    x, y = Args(2).tolist()
    denom = obsrad + m
    ellips = ((x - xobs) / denom) ** 2 + ((y - yobs) / denom) ** 2
    return 1.0 - ellips


def run(nsegs=128, print_level=1):
    """Returns (flag, transit time, phase)."""
    obsrad, m = 5, 2.5
    xobs, yobs = 0, 50
    la, lb = 1.58, 1.72
    x0, y0, psi0, v0, t0 = 0, 0, np.pi / 2, 15, 0
    accbound, vlbound, vubound = 2, 5, 29
    xf, yf = 0, 100
    tfIG = yf / v0

    TrajIG = []
    for t in np.linspace(0, tfIG, 100):
        X = np.zeros(7)
        X[0] = x0 + obsrad + m + 1.0   # bias guess to one side
        X[1] = yf * t / tfIG
        X[2] = psi0
        X[3] = v0
        X[4] = t
        TrajIG.append(X)

    ode = BikeODE(la, lb)
    phase = ode.phase("LGL3", TrajIG, nsegs)
    phase.addBoundaryValue("Front", [0, 1, 2, 3, 4], [x0, y0, psi0, v0, t0])
    phase.addLUVarBound("Path", 3, vlbound, vubound)
    phase.addLUVarBound("Path", 5, -accbound, accbound)
    phase.addLUVarBound("Path", 6, -np.pi / 6, np.pi / 6)
    phase.addInequalCon("Path", ObstacleConstraint(xobs, yobs, obsrad, m),
                        [0, 1])
    phase.addBoundaryValue("Back", [0, 1], [xf, yf])
    phase.addDeltaTimeObjective(1.0)
    phase.optimizer.set_tols(1.0e-9, 1.0e-9, 1.0e-9)
    phase.optimizer.PrintLevel = print_level
    flag = phase.optimize()
    return flag, phase.returnTraj()[-1][4], phase


if __name__ == "__main__":
    obsrad, m, yobs = 5, 2.5, 50
    flag, tt, phase = run()
    TrajF = phase.returnTraj()
    print("transit time (s):", tt)

    try:
        import matplotlib.pyplot as plt
        TT = np.array(TrajF).T
        plt.plot(TT[0], TT[1], label="bike path")
        angs = np.linspace(0, 2 * np.pi, 300)
        plt.plot(np.cos(angs) * obsrad, np.sin(angs) * obsrad + yobs,
                 "r", label="obstacle")
        plt.plot(np.cos(angs) * (obsrad + m),
                 np.sin(angs) * (obsrad + m) + yobs, "k--", label="margin")
        plt.grid(True); plt.axis("equal"); plt.legend()
        plt.show()
    except ImportError:
        pass
