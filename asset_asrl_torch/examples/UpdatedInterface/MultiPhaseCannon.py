"""Multi-phase cannonball, named-variable (Vgroups) interface (reference
`examples/UpdatedInterface/MultiPhaseCannon.py`, after the Dymos
multi-phase cannonball): pick the ball radius that maximizes range for a
fixed launch energy; ascent and descent phases share the radius as an
ODE parameter through a forward link."""

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


def ball_mass(rad):
    return (4 / 3) * (np.pi * RHOIRON) * rad ** 3


class Cannon(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(4, 0, 1)
        v, gamma, h, r = args.XVec().tolist()
        rad = args.PVar(0)
        S = np.pi * rad ** 2
        M = ball_mass(rad)
        rho = RHOAIR * vf.exp(-h / HSCALE)
        D = (0.5 * CD) * rho * (v ** 2) * S
        ode = vf.stack([-D / M - G * vf.sin(gamma),
                        -G * vf.cos(gamma) / v,
                        v * vf.sin(gamma), v * vf.cos(gamma)])
        Vgroups = {("v", "speed"): v, ("gamma", "fpa"): gamma,
                   ("h", "altitude"): h, ("r", "range"): r,
                   ("t", "time"): args.TVar(), ("rad", "radius"): rad}
        super().__init__(ode, 4, 0, 1, Vgroups=Vgroups)


def run(print_level=1):
    rad0 = .1 / LSTAR
    h0, r0 = 100 / LSTAR, 0
    v0 = np.sqrt(2 * E0 / ball_mass(rad0)) * .99

    ode = Cannon()
    integ = ode.integrator(.01)
    integ.setAbsTol(1e-13)
    IG = ode.make_input(v=v0, gamma=np.deg2rad(45), h=h0, r=r0, rad=rad0)

    apex = oc.ODEArguments(4, 0, 1)
    AscentIG = integ.integrate_dense(
        IG, 60 / TSTAR, [(apex[0] * vf.sin(apex[1]), 0, 1)])[0]
    DescentIG = integ.integrate_dense(
        AscentIG[-1], AscentIG[-1][4] + 1000 / TSTAR,
        [(oc.ODEArguments(4, 0, 1)[2], 0, 1)])[0]

    def launch_energy():
        v, rad = Args(2).tolist()
        return 0.5 * ball_mass(rad) * v ** 2 - E0

    aphase = ode.phase("LGL5", AscentIG, 96)
    aphase.addLowerVarBound("ODEParams", 0, 0.0, 1)
    aphase.addLowerVarBound("Front", "gamma", 0.0, 1.0)
    aphase.addBoundaryValue("Front", ["h", "r", "t"], [h0, r0, 0])
    aphase.addInequalCon("Front", launch_energy() * .01, ["v"], [0], [])
    aphase.addBoundaryValue("Back", ["gamma"], [0.0])

    dphase = ode.phase("LGL5", DescentIG, 96)
    dphase.addBoundaryValue("Back", ["h"], [0.0])
    dphase.addValueObjective("Back", "r", -1.0)

    ocp = oc.OptimalControlProblem()
    ocp.addPhase(aphase)
    ocp.addPhase(dphase)
    ocp.addForwardLinkEqualCon(aphase, dphase,
                               ["v", "gamma", "h", "r", "t"])
    ocp.addDirectLinkEqualCon(aphase, "ODEParams", [0],
                              dphase, "ODEParams", [0])
    ocp.optimizer.set_OptLSMode("AUGLANG")
    ocp.optimizer.PrintLevel = print_level
    ocp.optimize()
    atraj = aphase.returnTraj()
    dtraj = dphase.returnTraj()
    return atraj, dtraj


if __name__ == "__main__":
    atraj, dtraj = run()
    print(f"optimal radius : {dtraj[-1][5] * LSTAR * 100:.3f} cm")
    print(f"max range      : {dtraj[-1][3] * LSTAR / 1000:.3f} km")
