"""Multi-phase cannonball with a free design parameter (reference
`examples/MultiPhaseCannon.py`): choose the ball radius maximizing range for
a fixed launch energy; ascent/descent are separate phases linked through the
shared ODE parameter."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

G0, LSTAR, TSTAR, MSTAR = 9.81, 1000, 60.0, 10
ASTAR = LSTAR / TSTAR ** 2
RHOSTAR = MSTAR / LSTAR ** 3
ESTAR = MSTAR * (LSTAR / TSTAR) ** 2
CD = .5
RHOAIR = 1.225 / RHOSTAR
RHOIRON = 7870 / RHOSTAR
HSCALE = 8.44e3 / LSTAR
E0 = 400000 / ESTAR
G = G0 / ASTAR


def mass(rad):
    return (4 / 3) * (np.pi * RHOIRON) * rad ** 3


class Cannon(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(4, 0, 1)
        v, gamma, h, r = args.XVec().tolist()
        rad = args.PVar(0)
        S = np.pi * rad ** 2
        M = mass(rad)
        rho = RHOAIR * vf.exp(-h / HSCALE)
        D = (0.5 * CD) * rho * (v ** 2) * S
        ode = vf.stack([-D / M - G * vf.sin(gamma),
                        -G * vf.cos(gamma) / v,
                        v * vf.sin(gamma), v * vf.cos(gamma)])
        super().__init__(ode, 4, 0, 1)


if __name__ == "__main__":
    rad0 = .1 / LSTAR
    h0, r0 = 100 / LSTAR, 0
    gamma0 = np.deg2rad(45)
    v0 = np.sqrt(2 * E0 / mass(rad0)) * .99

    ode = Cannon()
    integ = ode.integrator(.01)
    integ.setAbsTol(1e-13)
    IG = np.zeros(6)
    IG[0], IG[1], IG[2], IG[3], IG[5] = v0, gamma0, h0, r0, rad0

    # events split the ballistic guess at apex and impact
    apex = oc.ODEArguments(4, 0, 1)
    AscentIG = integ.integrate_dense(
        IG, 60 / TSTAR, [(apex[0] * vf.sin(apex[1]), 0, 1)])[0]
    DescentIG = integ.integrate_dense(
        AscentIG[-1], AscentIG[-1][4] + 1000 / TSTAR,
        [(oc.ODEArguments(4, 0, 1)[2], 0, 1)])[0]

    def EFunc():
        v, rad = Args(2).tolist()
        return 0.5 * mass(rad) * v ** 2 - E0

    aphase = ode.phase("LGL5", AscentIG, 96)
    aphase.addLowerVarBound("ODEParams", 0, 0.0, 1)
    aphase.addLowerVarBound("Front", 1, 0.0, 1.0)
    aphase.addBoundaryValue("Front", [2, 3, 4], [h0, r0, 0])
    aphase.addInequalCon("Front", EFunc() * .01, [0], [0], [])
    aphase.addBoundaryValue("Back", [1], [0.0])

    dphase = ode.phase("LGL5", DescentIG, 96)
    dphase.addBoundaryValue("Back", [2], [0.0])
    dphase.addValueObjective("Back", 3, -1.0)

    ocp = oc.OptimalControlProblem()
    ocp.addPhase(aphase)
    ocp.addPhase(dphase)
    ocp.addForwardLinkEqualCon(aphase, dphase, [0, 1, 2, 3, 4])
    ocp.addDirectLinkEqualCon(0, "ODEParams", [0], 1, "ODEParams", [0])
    ocp.optimizer.set_OptLSMode("L1")
    ocp.optimizer.PrintLevel = 1
    ocp.optimize()

    D = dphase.returnTraj()
    print("range (m):", D[-1][3] * LSTAR, "(reference ~3280)")
    print("optimal radius (m):", D[-1][-1] * LSTAR, "(reference ~0.042)")

    try:
        import matplotlib.pyplot as plt
        for T, lab in ((aphase.returnTraj(), "ascent"), (D, "descent")):
            TT = np.array(T).T
            plt.plot(TT[3] * LSTAR, TT[2] * LSTAR, label=lab)
        plt.xlabel("range (m)"); plt.ylabel("h (m)")
        plt.grid(True); plt.legend(); plt.show()
    except ImportError:
        pass
