"""CartPole swing-up with adaptive mesh refinement (reference
`examples/MeshRefinement/CartPole.py`): converges to objective 58.8322
with the de Boor estimator."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class CartPole(oc.ODEBase):
    def __init__(self, l, m1, m2, g):
        XtU = oc.ODEArguments(4, 1)
        x, th, xd, thd = XtU.XVec().tolist()
        F = XtU.UVar(0)
        Q = vf.stack([-g * vf.sin(th), F + m2 * l * vf.sin(th) * thd ** 2])
        M = vf.RowMatrix(vf.stack(vf.cos(th), l, m1 + m2,
                                  m2 * l * vf.cos(th)), 2, 2)
        super().__init__(vf.stack([xd, thd, M.inverse() * Q]), 4, 1)


def run(nsegs=20, estimator="deboor", print_level=1):
    m1, m2, l, g = 1, .3, .5, 9.81
    tf, xf = 2.0, 1.0
    ts = np.linspace(0, tf, 100)
    IG = [[xf * t / tf, np.pi * t / tf, 0, 0, t, .0] for t in ts]
    phase = CartPole(l, m1, m2, g).phase("LGL5", IG, nsegs)
    phase.addBoundaryValue("First", range(0, 5), [0, 0, 0, 0, 0])
    phase.addBoundaryValue("Last", range(0, 5), [xf, np.pi, 0, 0, tf])
    phase.addLUVarBound("Path", 5, -20.0, 20.0)
    phase.addIntegralObjective(Args(1)[0] ** 2, [5])
    phase.optimizer.set_PrintLevel(print_level)
    phase.setAdaptiveMesh(True)
    phase.setMeshTol(1.0e-7)
    phase.setMeshErrorEstimator(estimator)
    flag = phase.optimize()
    return flag, phase


if __name__ == "__main__":
    flag, phase = run()
    print(f"flag {flag}, objective {phase.optimizer.LastObjVal:.6f} "
          f"(known 58.832192), final segs {phase.numSegs}")
