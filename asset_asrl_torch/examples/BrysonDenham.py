"""Classic Bryson-Denham state-constrained double integrator (reference
`examples/BrysonDenham.py`).  Analytic optimum of the objective is 4/(9*l)
with l = 1/9 -> J = 4."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class Model(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(2, 1)
        x, v = args.XVec().tolist()
        u = args.UVec()[0]
        super().__init__(vf.stack([v, u]), 2, 1)


def run(nsegs=32, print_level=1):
    """Returns (flag, objective, phase); analytic optimum 4/(9*l)/... = 4
    for the l = 1/9 state bound."""
    n = 100
    ts = np.linspace(0, 1, n)
    vs = np.linspace(1, -1, n)
    IG = [[.0, v, t, 0] for t, v in zip(ts, vs)]

    ode = Model()
    phase = ode.phase("LGL5", IG, nsegs)
    phase.addBoundaryValue("Front", range(0, 3), [0, 1, 0])
    phase.addUpperVarBound("Path", 0, 1 / 9)
    phase.addIntegralObjective((Args(1)[0] ** 2) / 2, [3])
    phase.addBoundaryValue("Back", range(0, 3), [0, -1, 1])
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_KKTtol(1.0e-10)
    phase.optimizer.set_PrintLevel(print_level)
    flag = phase.optimize()
    return flag, phase.optimizer.LastObjVal, phase


if __name__ == "__main__":
    flag, obj, phase = run()
    print("objective:", obj, "(analytic 4/(9*l) with l=1/9 -> 4)")

    try:
        import matplotlib.pyplot as plt
        TT = np.array(phase.returnTraj()).T
        fig, axs = plt.subplots(3, 1)
        axs[0].plot(TT[2], TT[0]); axs[0].set_ylabel(r"$x$")
        axs[1].plot(TT[2], TT[1]); axs[1].set_ylabel(r"$v$")
        axs[2].plot(TT[2], TT[3]); axs[2].set_ylabel(r"$u$")
        axs[2].set_xlabel(r"$t$")
        for ax in axs:
            ax.grid(True)
        plt.show()
    except ImportError:
        pass
