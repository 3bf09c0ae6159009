"""Planar low-thrust orbit raising r=1 -> r=2 under three objectives
(time / power / mass optimal), reference `examples/SimpleLowThrust.py`.

Exercises the integrator control-law closure (initial guess from a
tangential-thrust feedback law), norm path bounds, objective swapping on a
live phase, and costate extraction."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class LTModel(oc.ODEBase):
    def __init__(self, mu, ltacc):
        args = oc.ODEArguments(6, 3)
        r = args.head3()
        v = args.segment3(3)
        u = args.tail3()
        g = r.normalized_power3() * (-mu)
        acc = g + u * ltacc
        super().__init__(vf.stack([v, acc]), 6, 3)

    class massobj(vf.ScalarFunction):
        def __init__(self, scale):
            u = Args(3)
            super().__init__(u.norm() * scale)

    class powerobj(vf.ScalarFunction):
        def __init__(self, scale):
            u = Args(3)
            super().__init__(u.norm().squared() * scale)


def run(nsegs=128, print_level=1):
    mu, acc = 1.0, .02
    ode = LTModel(mu, acc)

    r0, rf = 1.0, 2.0
    v0, vF = np.sqrt(mu / r0), np.sqrt(mu / rf)
    X0 = np.zeros(7)
    X0[0], X0[4] = r0, v0
    Xf = np.zeros(6)
    Xf[0], Xf[4] = rf, vF

    XIG = np.zeros(10)
    XIG[0:7] = X0

    # thrust at 0.8 throttle along the velocity direction (control law
    # closure over [x, t]: reference integ = ode.integrator(.01, law, uvars))
    law = Args(3).normalized() * .8
    integ = ode.integrator(.01, law, [3, 4, 5])
    TrajIG = integ.integrate_dense(XIG, 6.4 * np.pi, 100)

    phase = ode.phase("LGL3", TrajIG, nsegs)
    phase.addBoundaryValue("Front", range(0, 7), X0)
    phase.addLUNormBound("Path", [7, 8, 9], .001, 1, 1.0)
    phase.addBoundaryValue("Back", range(0, 6), Xf[0:6])
    phase.optimizer.set_PrintLevel(print_level)
    phase.optimizer.set_BoundFraction(.995)
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_MaxLSIters(2)
    phase.optimizer.set_deltaH(1.0e-6)

    phase.addDeltaTimeObjective(1.0)
    phase.optimize()
    TimeOptimal = phase.returnTraj()
    TimeCostates = phase.returnCostateTraj()
    phase.removeStateObjective(-1)

    phase.addIntegralObjective(LTModel.powerobj(0.5), [7, 8, 9])
    phase.optimize()
    PowerOptimal = phase.returnTraj()
    phase.removeIntegralObjective(-1)

    phase.addIntegralObjective(LTModel.massobj(1.0), [7, 8, 9])
    phase.optimize()
    MassOptimal = phase.returnTraj()
    MassCostates = phase.returnCostateTraj()

    return dict(time=TimeOptimal, power=PowerOptimal, mass=MassOptimal,
                time_costates=TimeCostates, mass_costates=MassCostates)


if __name__ == "__main__":
    out = run()
    tt = np.asarray(out["time"])
    print(f"time-optimal tof = {tt[-1][6]:.6f} "
          f"(final r = {np.linalg.norm(tt[-1][0:3]):.6f})")
    mt = np.asarray(out["mass"])
    ueff = np.sum(np.linalg.norm(mt[:, 7:10], axis=1)) / len(mt)
    print(f"mass-optimal mean throttle = {ueff:.4f}")
