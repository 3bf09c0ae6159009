"""Betts' LEO->MEO low-thrust zonal-harmonics transfer, named-variable
(Vgroups) interface (reference `examples/UpdatedInterface/
BettsLowThrust.py`): MEE states + weight named, RTN control group, named
bounds, throttle as a named ODE parameter."""

import numpy as np


import asset_asrl_torch as ast
from ..BettsLowThrust import (LTModel as _BaseLT, MEECartFunc, RTNBasisFunc,
                              RadFunc, EqBCon, IqBCon, mu, Thrust, gs, Isp,
                              Re, J2, pt0, Fstar, Tstar)

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class LTModel(_BaseLT):
    def __init__(self):
        super().__init__(mu, Thrust, gs, Isp, Re, J2)
        XtUP = oc.ODEArguments(7, 3, 1)
        self.add_Vgroups({("mee",): XtUP.XVec().head(6),
                          ("w", "weight"): XtUP.XVar(6),
                          ("t", "time"): XtUP.TVar(),
                          ("u", "rtn"): XtUP.UVec().head3(),
                          ("tau", "throttle"): XtUP.PVar(0)})


def run(nsegs=16, adaptive=True, print_level=1):
    ode = LTModel()
    X0 = np.asarray(ode.make_input(
        mee=[pt0, 0, 0, -0.25396764647494, 0, np.pi],
        w=1 / Fstar, u=[0, 1, 0], tau=-25))

    def Prograde():
        RV = MEECartFunc(mu)
        RTNBasis = RTNBasisFunc()(RV)
        return vf.RowMatrix(RTNBasis, 3, 3) * RV.tail(3).normalized()

    integ = ode.integrator(.1, Prograde(), range(0, 6))
    IG = integ.integrate_dense(X0, 90000 / Tstar)

    phase = ode.phase("LGL5", IG, nsegs)
    phase.addBoundaryValue("Front", ["mee", "w", "t"], X0[0:8])
    phase.addEqualCon("Path", Args(3).norm() - 1, ["u"])
    phase.setControlMode("NoSpline")
    phase.addLUFuncBound("Path", RadFunc(mu), ["mee"], Re, 10 * Re)
    phase.addEqualCon("Back", EqBCon(), ["mee"])
    phase.addInequalCon("Back", IqBCon(), ["mee"])
    phase.addLUVarBound("ODEParams", 0, -50, 0)
    phase.addLowerVarBound("Back", "w", .05)
    phase.addValueObjective("Back", "w", -1.0)
    phase.optimizer.PrintLevel = print_level
    phase.optimizer.set_EContol(1.0e-9)
    if adaptive:
        phase.setAdaptiveMesh(True)
        phase.setMeshErrorEstimator("integrator")
        phase.setMeshTol(1.0e-7)
    flag = phase.optimize_solve()
    Traj = phase.returnTraj()
    print(f"Final Weight: {Traj[-1][6] * Fstar} lb")
    return flag, Traj[-1][6] * Fstar, Traj


if __name__ == "__main__":
    run()
