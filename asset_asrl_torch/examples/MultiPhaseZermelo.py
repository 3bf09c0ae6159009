"""Multi-phase Zermelo navigation through waypoints under several wind
models, linked by forward continuity (reference
`examples/MultiPhaseZermelo.py`): one phase per waypoint leg, positions and
time chained with addForwardLinkEqualCon."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

nSeg = 40
tol = 1e-10


class Zermelo(oc.ODEBase):
    def __init__(self, vMax, wFunc):
        args = Args(2 + 1 + 1)     # time-dependent wind -> build over [x,t,u]
        xyt = args.head(3)
        th = args[3]
        wx, wy = wFunc(xyt)
        xD = vMax * vf.cos(th) + wx
        yD = vMax * vf.sin(th) + wy
        super().__init__(vf.stack([xD, yD]), 2, 1)


def noWind(xyt):
    return 0, 0


def uniformWind(xyt, ang=135 * np.pi / 180, vel=2):
    return vel * np.cos(ang), vel * np.sin(ang)


def constantDirWind(xyt, ang=45 * np.pi / 180):
    vel = vf.cos(xyt.head(2).norm())
    return vel * np.cos(ang), vel * np.sin(ang)


def variableDirWind(xyt):
    vel = vf.sin(xyt.head(2).norm())
    ang = 2 * (xyt[0] + xyt[1])
    return vel * vf.cos(ang), vel * vf.sin(ang)


def navigate(Points, vM=1, wF=uniformWind, print_level=2):
    numphase = len(Points) - 1
    trajG = []
    for i in range(numphase):
        A, B = Points[i], Points[i + 1]
        dist = np.linalg.norm(B - A)
        t0 = dist / vM
        d = (B - A) / dist
        ang = np.arctan2(d[1], d[0])
        trajG.append([np.array(list(A + d * x) + [t0 * x, ang])
                      for x in np.linspace(0, 1, num=nSeg)])

    ocp = oc.OptimalControlProblem()
    for i in range(numphase):
        A, B = Points[i], Points[i + 1]
        phase = Zermelo(vM, wF).phase("LGL3")
        phase.setTraj(trajG[i], nSeg)
        if i == 0:
            phase.addBoundaryValue("Front", [0, 1], A)
            phase.addBoundaryValue("Front", [2], [0.0])
        phase.addBoundaryValue("Back", [0, 1], B)
        phase.addLUVarBound("Path", 3, -np.pi, np.pi, 1)
        phase.addDeltaTimeObjective(1.0)
        phase.addLowerDeltaTimeBound(0)
        ocp.addPhase(phase)

    # chain position + time continuity across the whole waypoint sequence
    ocp.addForwardLinkEqualCon(0, -1, [0, 1, 2])
    ocp.optimizer.set_EContol(tol)
    ocp.optimizer.set_KKTtol(tol)
    ocp.optimizer.PrintLevel = print_level
    ocp.solve_optimize()

    out = []
    for ph in ocp.Phases:
        out += ph.returnTraj()
    return out, ocp


if __name__ == "__main__":
    Points = [np.array(p) for p in
              [[0, 0], [2, 1], [3, 3], [1, 4]]]
    # boat speed must exceed the uniform wind's 2.0 for the waypoint
    # problem to be well-posed (the boat cannot hold a line otherwise)
    for name, wf in [("uniform", uniformWind),
                     ("constantDir", constantDirWind),
                     ("variableDir", variableDirWind)]:
        traj, ocp = navigate(Points, vM=2.5, wF=wf, print_level=1)
        print(f"{name}: total time {traj[-1][2]:.6f} over "
              f"{len(ocp.Phases)} phases")
