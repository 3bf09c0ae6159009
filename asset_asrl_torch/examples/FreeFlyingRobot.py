"""Free-flying robot minimum-fuel slew (reference
`examples/FreeFlyingRobotExample.py`; problem from arXiv:1905.11898):
4 one-sided thrusters move a planar robot between two rest poses."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class FreeFlyingRobotODE(oc.ODEBase):
    def __init__(self, alpha, beta):
        args = oc.ODEArguments(6, 4)
        xydot = args.XVec().segment2(2)
        theta = args.XVar(4)
        omega = args.XVar(5)
        u = args.UVec()
        vscale = u[0] - u[1] + u[2] - u[3]
        vxydot = vf.stack([vf.cos(theta), vf.sin(theta)]) * vscale
        omega_dot = (u[0] - u[1]) * alpha + (u[3] - u[2]) * beta
        ode = vf.stack([xydot, vxydot, omega, omega_dot])
        super().__init__(ode, 6, 4)


def run(nsegs=128, print_level=1):
    """Returns (flag, fuel objective, phase); arXiv:1905.11898 reports
    J* ~= 7.910 for this alpha = beta = 0.2 configuration."""
    ode = FreeFlyingRobotODE(.2, .2)
    t0, tf = 0, 12
    X0 = np.array([-10, -10, 0, 0, np.pi / 2.0, 0, 0])
    XF = np.array([0, 0, 0, 0, 0, 0, tf])

    IG = []
    for t in np.linspace(0, tf, 100):
        T = np.zeros(11)
        T[0:7] = X0 + ((t - t0) / (tf - t0)) * (XF - X0)
        T[7:11] = .5
        IG.append(T)

    phase = ode.phase("LGL5", IG, nsegs)
    phase.addBoundaryValue("Front", range(0, 7), X0)
    phase.addBoundaryValue("Back", range(0, 7), XF)
    phase.addLUVarBounds("Path", range(7, 11), 0.0, 1.0, 1)
    phase.addIntegralObjective(Args(4).sum(), range(7, 11))
    phase.optimizer.set_PrintLevel(print_level)
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_MaxLSIters(2)
    phase.optimizer.set_tols(1.0e-9, 1.0e-9, 1.0e-9)
    flag = phase.optimize()
    return flag, phase.optimizer.LastObjVal, phase


if __name__ == "__main__":
    flag, obj, phase = run()
    Traj = phase.returnTraj()
    print("fuel objective:", obj)

    try:
        import matplotlib.pyplot as plt
        TT = np.array(Traj).T
        fig, axs = plt.subplots(1, 2, figsize=(10, 4))
        axs[0].plot(TT[0], TT[1]); axs[0].set_xlabel("X")
        axs[0].set_ylabel("Y"); axs[0].grid(True)
        axs[1].plot(TT[6], TT[7] - TT[8], label="u1-u2")
        axs[1].plot(TT[6], TT[9] - TT[10], label="u4-u3")
        axs[1].grid(True); axs[1].legend(); axs[1].set_xlabel("t")
        plt.show()
    except ImportError:
        pass
