"""Long-horizon hyper-sensitive problem (tf=10000) with adaptive mesh
refinement, reference `examples/MeshRefinement/HyperSensLong.py`
(Patterson/Hager/Rao benchmark).  Analytic objective ~ 3.3620563."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class HyperSens(oc.ODEBase):
    def __init__(self, cubed=False):
        XtU = oc.ODEArguments(1, 1)
        x = XtU.XVar(0)
        u = XtU.UVar(0)
        xdot = -(x ** 3) + u if cubed else -x + u
        super().__init__(xdot, 1, 1)


def run(tf=10000.0, nsegs=50, estimator="deboor", print_level=1):
    xt0, xtf = 1.5, 1.0
    ode = HyperSens(False)
    TrajIG = [[xt0 * (1 - t / tf) + xtf * (t / tf), t, 0]
              for t in np.linspace(0, tf, 1000)]
    phase = ode.phase("LGL7", TrajIG, nsegs)
    phase.setControlMode("NoSpline")
    phase.addBoundaryValue("First", [0, 1], [xt0, 0])
    phase.addBoundaryValue("Last", [0, 1], [xtf, tf])
    phase.addIntegralObjective(Args(2).squared_norm() / 2, [0, 2])
    phase.addLUVarBound("Path", 0, -50, 50)
    phase.addLUVarBound("Path", 2, -50, 50)
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_SoeLSMode("L1")
    phase.optimizer.set_MaxLSIters(2)
    phase.optimizer.PrintLevel = print_level
    phase.setAdaptiveMesh(True)
    phase.setMeshTol(1.0e-7)
    phase.optimizer.set_EContol(1.0e-7)
    phase.setMaxMeshIters(10)
    phase.setMeshErrorEstimator(estimator)
    phase.setMeshErrorCriteria("max")
    flag = phase.optimize()
    return flag, phase


if __name__ == "__main__":
    flag, phase = run()
    print(f"flag {flag}, objective {phase.optimizer.LastObjVal:.7f} "
          f"(analytic ~3.3620563), final segs {phase.numSegs}")
