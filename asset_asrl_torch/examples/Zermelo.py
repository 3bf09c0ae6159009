"""Zermelo's navigation problem (reference `examples/Zermelo.py`): steer a
boat through several wind fields between two points in minimum time."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl

nSeg = 250
tol = 1e-12


class Zermelo(oc.ODEBase):
    def __init__(self, vMax, wFunc):
        # time-dependent wind -> build from raw Arguments over [x, y, t, theta]
        args = vf.Arguments(2 + 1 + 1)
        xyt = args.head3()
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
    vel = vf.cos(xyt.head2().norm())
    return vel * np.cos(ang), vel * np.sin(ang)


def variableDirWind(xyt):
    vel = vf.sin(xyt.head2().norm())
    ang = 2 * (xyt[0] + xyt[1])
    return vel * vf.cos(ang), vel * vf.sin(ang)


def navigate(A, B, vM=1, wF=uniformWind, nseg=None, tols=None,
             print_level=1):
    nseg = nSeg if nseg is None else int(nseg)
    tols = tol if tols is None else float(tols)
    dist = np.linalg.norm(B - A)
    t0 = dist / vM
    d = (B - A) / dist
    ang = np.arctan2(d[1], d[0])
    trajG = [np.array(list(A + d * x) + [t0 * x, ang])
             for x in np.linspace(0, 1, num=nseg)]

    phase = Zermelo(vM, wF).phase("LGL3")
    phase.setTraj(trajG, nseg)
    phase.addBoundaryValue("Front", [0, 1], A)
    phase.addBoundaryValue("Front", [2], [0.0])
    phase.addBoundaryValue("Back", [0, 1], B)
    phase.addLUVarBound("Path", 3, -np.pi, np.pi, 1)
    phase.addDeltaTimeObjective(1.0)
    phase.optimizer.set_EContol(tols)
    phase.optimizer.set_KKTtol(tols)
    phase.optimizer.PrintLevel = print_level
    flag = phase.solve_optimize()
    return phase.returnTraj(), flag


if __name__ == "__main__":
    A = np.array([0, -1])
    B = np.array([1, 1])
    vM = 1.25

    t1, _ = navigate(A, B, vM=1, wF=noWind)
    t2, _ = navigate(A, B, vM=vM, wF=lambda xyt: uniformWind(xyt, vel=0.5))
    t3, _ = navigate(A, B, vM=vM, wF=constantDirWind)
    t4, _ = navigate(A, B, vM=vM, wF=variableDirWind)

    for i, t in enumerate([t1, t2, t3, t4]):
        print(f"wind model {i}: transfer time {t[-1][2]:.6f}")

    try:
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(12, 8))
        for i, t in enumerate([t1, t2, t3, t4]):
            axes[0].plot([X[0] for X in t], [X[1] for X in t],
                         label=f"Path {i}")
            axes[1].plot([X[2] for X in t], [X[3] for X in t])
        axes[0].grid(True); axes[0].set_xlabel("X"); axes[0].set_ylabel("Y")
        axes[1].grid(True); axes[1].set_xlabel("Time")
        axes[1].set_ylabel(r"$\theta$ (rad)")
        axes[0].legend()
        plt.tight_layout(); plt.show()
    except ImportError:
        pass
