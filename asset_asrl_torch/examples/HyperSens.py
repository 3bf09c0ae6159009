"""Hyper-sensitive problem (reference `examples/HyperSens.py`; Rao et al.):
a boundary-layer problem over a very long horizon tf=10000, the classic
adaptive-mesh benchmark."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class HyperSens(oc.ODEBase):
    def __init__(self):
        XtU = oc.ODEArguments(1, 1)
        x = XtU.XVar(0)
        u = XtU.UVar(0)
        super().__init__(-x + u, 1, 1)


if __name__ == "__main__":
    xt0, xtf, tf = 1.5, 1.0, 10000.0
    ode = HyperSens()
    TrajIG = [[xt0 * (1 - t / tf) + xtf * (t / tf), t, 0]
              for t in np.linspace(0, tf, 1000)]

    phase = ode.phase("LGL7", TrajIG, 10)
    phase.addBoundaryValue("First", [0, 1], [xt0, 0])
    phase.addBoundaryValue("Last", [0, 1], [xtf, tf])
    phase.addIntegralObjective(Args(2).squared_norm() / 2, [0, 2])
    phase.addLUVarBound("Path", 0, -50, 50)
    phase.addLUVarBound("Path", 2, -50, 50)
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_SoeLSMode("L1")
    phase.optimizer.PrintLevel = 1

    phase.setAdaptiveMesh(True)
    phase.setMeshTol(1.0e-6)
    phase.setMaxMeshIters(10)
    phase.optimizer.set_EContol(1.0e-7)

    flag = phase.optimize_solve()
    print("Success" if (phase.MeshConverged and
                        flag == ast.Solvers.ConvergenceFlags.CONVERGED)
          else "Failure")
    print("objective:", phase.optimizer.LastObjVal,
          "(analytic boundary-layer value ~6.7241)")

    try:
        import matplotlib.pyplot as plt
        TT = np.array(phase.returnTraj()).T
        ax0 = plt.subplot(211); ax1 = plt.subplot(223); ax2 = plt.subplot(224)
        for ax in (ax0, ax1, ax2):
            ax.grid(True)
            ax.plot(TT[1], TT[0], label="x", marker="o")
            ax.plot(TT[1], TT[2], label="u", marker="o")
            ax.set_xlabel("t")
        ax0.legend()
        ax1.set_xlim([-.5, 12]); ax2.set_xlim([tf - 12, tf + .5])
        plt.show()
    except ImportError:
        pass
