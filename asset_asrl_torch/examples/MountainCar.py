"""Mountain-car minimum-time escape (reference `examples/MountainCar.py`;
problem from the dymos docs).  The engine is too weak to climb directly, so
the optimal policy oscillates to build speed."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class MountainCar(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(2, 1)
        x, v = args.XVar(0), args.XVar(1)
        u = args.UVar(0)
        xdot = v
        vdot = .001 * u - .0025 * vf.cos(3 * x)
        super().__init__(vf.stack([xdot, vdot]), 2, 1)


def run(nsegs=128, print_level=1):
    """Returns (flag, escape time, phase); dymos reference ~103."""
    ode = MountainCar()
    x0, v0, xf, tf = -.5, 0, .52, 500

    IG = [[x0 + (xf - x0) * t / tf, t / tf, t, np.sin(t / tf)]
          for t in np.linspace(0, tf, 100)]

    phase = ode.phase("LGL3", IG, nsegs)
    phase.addBoundaryValue("First", [0, 1, 2], [x0, v0, 0])
    phase.addBoundaryValue("Last", [0], [xf])
    phase.addLowerVarBound("Back", 1, 0.0, 1.0)
    phase.addLUVarBound("Path", 0, -1.2, .55, 1.0)
    phase.addLUVarBound("Path", 1, -0.07, .07, 100.0)  # scale to order 1
    phase.addLUVarBound("Path", 3, -1, 1, 1.0)
    phase.addDeltaTimeObjective(0.01)                  # scale to order 1

    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_PrintLevel(print_level)
    flag = phase.solve_optimize()
    return flag, phase.returnTraj()[-1][2], phase


if __name__ == "__main__":
    flag, t_escape, phase = run()
    Traj = phase.returnTraj()
    print("escape time:", t_escape, "(dymos reference ~103)")

    try:
        import matplotlib.pyplot as plt
        TT = np.array(Traj).T
        fig, axs = plt.subplots(3, 1, sharex=True)
        for ax, var, lab in zip(axs, [0, 1, 3], ["x", "v", "u"]):
            ax.plot(TT[2], TT[var]); ax.set_ylabel(lab); ax.grid(True)
        axs[2].set_xlabel("t")
        plt.show()
    except ImportError:
        pass
