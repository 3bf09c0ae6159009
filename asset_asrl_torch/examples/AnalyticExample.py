"""LQR-like problem with a closed-form solution (reference
`examples/AnalyticExample.py`; formulation from Hindawi AAA 2014/851720).
Verifies collocation controls and costates against the analytic optimum."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class ODE(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(1, 1)
        x = args.XVar(0)
        u = args.UVar(0)
        xdot = .5 * x + u
        super().__init__(xdot, 1, 1)

    class obj(vf.ScalarFunction):
        def __init__(self):
            x, u = Args(2).tolist()
            super().__init__(u * u + x * u + 1.25 * x ** 2)


def run(nsegs=20, print_level=1):
    """Solve and compare against the closed-form control/costate; returns
    (flag, max |U - U*|, max |L - L*|, phase)."""
    ode = ODE()
    x0, t0, tf, u0 = 1.0, 0.0, 1.0, 0.0

    TrajIG = [[x0, t, u0] for t in np.linspace(t0, tf, 100)]
    phase = ode.phase("LGL5", TrajIG, nsegs)
    phase.addBoundaryValue("Front", [0, 1], [x0, t0])
    phase.addBoundaryValue("Back", [1], [tf])
    phase.addIntegralObjective(ODE.obj(), [0, 2])
    phase.optimizer.PrintLevel = print_level
    flag = phase.optimize()

    T = np.array(phase.returnTraj()).T
    CT = np.array(phase.returnCostateTraj()).T
    t = T[1]
    U = T[2]
    L = CT[0]
    # analytic costates / control
    Lstar = 2 * np.cosh(1 - t) * np.tanh(1 - t) / np.cosh(1)
    Ustar = -(np.tanh(1 - t) + .5) * np.cosh(1 - t) / np.cosh(1)
    uerr = float(np.abs(U - Ustar).max())
    lerr = float(np.abs(L - Lstar[:len(L)]).max())
    return flag, uerr, lerr, phase


if __name__ == "__main__":
    flag, uerr, lerr, phase = run()
    T = np.array(phase.returnTraj()).T
    CT = np.array(phase.returnCostateTraj()).T
    t, U, L = T[1], T[2], CT[0]
    Lstar = 2 * np.cosh(1 - t) * np.tanh(1 - t) / np.cosh(1)
    Ustar = -(np.tanh(1 - t) + .5) * np.cosh(1 - t) / np.cosh(1)

    print("max |U - U*| =", uerr)
    print("max |L - L*| =", lerr)

    try:
        import matplotlib.pyplot as plt
        plt.plot(t, U, marker="o", label="U collocation")
        plt.plot(t, Ustar, label="U analytic")
        plt.plot(t[:len(L)], L, marker="o", label="L collocation")
        plt.plot(t, Lstar, label="L analytic")
        plt.legend(); plt.grid(True); plt.xlabel("t")
        plt.show()
    except ImportError:
        pass
