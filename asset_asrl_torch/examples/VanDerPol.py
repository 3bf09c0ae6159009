"""Van der Pol oscillator optimal control (reference `examples/VanDerPol.py`;
problem from the dymos docs).  Minimize the integral of x0^2+x1^2+u^2 while
driving the oscillator to the origin in fixed time."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class VanderPol(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(2, 1)
        x0, x1, u = args[0], args[1], args[3]
        x0dot = (1.0 - x1 * x1) * x0 - x1 + u
        x1dot = x0
        super().__init__(vf.stack(x0dot, x1dot), 2, 1)


if __name__ == "__main__":
    ode = VanderPol()
    tf = 10.0
    TrajIG = [[0, 1, t, 0] for t in np.linspace(0, tf, 100)]

    phase = ode.phase("LGL3", TrajIG, 128)
    phase.setControlMode("BlockConstant")
    phase.addBoundaryValue("Front", range(0, 3), [0, 1, 0])
    phase.addLUVarBound("Path", 3, -0.75, 1.0, 1.0)
    phase.addIntegralObjective(Args(3).squared_norm(), [0, 1, 3])
    phase.addBoundaryValue("Back", [0, 1, 2], [0.0, 0.0, tf])
    phase.optimizer.PrintLevel = 1
    phase.optimizer.set_tols(1.0e-8, 1.0e-8, 1.0e-8)
    phase.optimize()

    Traj = phase.returnTraj()
    print("objective:", phase.optimizer.LastObjVal, "(dymos ref ~2.87)")

    try:
        import matplotlib.pyplot as plt
        T = np.array(Traj).T
        plt.plot(T[2], T[0], label=r"$x_0$")
        plt.plot(T[2], T[1], label=r"$x_1$")
        plt.plot(T[2], T[3], label=r"$u$")
        plt.grid(True); plt.legend(); plt.xlabel(r"$t$")
        plt.show()
    except ImportError:
        pass
