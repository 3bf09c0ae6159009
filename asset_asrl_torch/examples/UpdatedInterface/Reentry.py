"""Space-shuttle reentry via the named-variable (Vgroups) interface
(reference `examples/UpdatedInterface/Reentry.py`; Betts problem 6.2):
named states/controls, named units + autoscaling, adaptive mesh.
Objectives: 34.14 deg unconstrained crossrange, 30.63 deg with the
70 BTU heating-rate limit."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

g0, W = 32.2, 203000
Lstar, Tstar = 100000.0, 60.0
Mstar = W / g0
Vstar = Lstar / Tstar
Rhostar = Mstar / Lstar ** 3
Mustar = Lstar ** 3 / Tstar ** 2

tmax = 2500 / Tstar
Re = 20902900 / Lstar
S = 2690.0 / Lstar ** 2
m = (W / g0) / Mstar
mu = 0.140765e17 / Mustar
rho0 = .002378 / Rhostar
h_ref = 23800 / Lstar
a0, a1 = -.20704, .029244
b0, b1, b2 = .07854, -.61592e-2, .621408e-3
c0, c1, c2, c3 = 1.0672181, -.19213774e-1, .21286289e-3, -.10117e-5
Qlimit = 70.0


class ShuttleReentry(oc.ODEBase):
    def __init__(self):
        XtU = oc.ODEArguments(5, 2)
        h, theta, v, gamma, psi = XtU.XVec().tolist()
        alpha, beta = XtU.UVec().tolist()
        alphadeg = (180.0 / np.pi) * alpha
        CL = a0 + a1 * alphadeg
        CD = b0 + b1 * alphadeg + b2 * (alphadeg ** 2)
        rho = rho0 * vf.exp(-h / h_ref)
        r = h + Re
        L = 0.5 * CL * S * rho * (v ** 2)
        D = 0.5 * CD * S * rho * (v ** 2)
        g = mu / (r ** 2)
        sgam, cgam = vf.sin(gamma), vf.cos(gamma)
        hdot = v * sgam
        thetadot = (v / r) * cgam * vf.cos(psi)
        vdot = -D / m - g * sgam
        gammadot = (L / (m * v)) * vf.cos(beta) + cgam * (v / r - g / v)
        psidot = L * vf.sin(beta) / (m * v * cgam) \
            + (v / r) * cgam * vf.sin(psi) * vf.tan(theta)
        Vgroups = {("h", "altitude"): h, ("theta", "longitude"): theta,
                   ("v", "speed"): v, ("gamma", "fpa"): gamma,
                   ("psi", "heading"): psi, ("t", "time"): XtU.TVar(),
                   ("alpha", "aoa"): alpha, ("beta", "bank"): beta}
        super().__init__(vf.stack([hdot, thetadot, vdot, gammadot, psidot]),
                         5, 2, Vgroups=Vgroups)


def heating_rate():
    h, v, alpha = Args(3).tolist()
    alphadeg = (180.0 / np.pi) * alpha
    rhodim = rho0 * vf.exp(-h / h_ref) * Rhostar
    vdim = v * Vstar
    qr = 17700 * vf.sqrt(rhodim) * ((.0001 * vdim) ** 3.07)
    qa = c0 + c1 * alphadeg + c2 * alphadeg ** 2 + c3 * alphadeg ** 3
    return qa * qr


def run(print_level=1, heat_constrained=True):
    tf = 1000 / Tstar
    ht0, htf = 260000 / Lstar, 80000 / Lstar
    vt0, vtf = 25600 / Vstar, 2500 / Vstar
    gammat0, gammatf = np.deg2rad(-1.0), np.deg2rad(-5.0)

    ode = ShuttleReentry()
    units = ode.make_units(h=Lstar, v=Vstar, t=Tstar)

    TrajIG = []
    for t in np.linspace(0, tf, 200):
        X = ode.make_input(
            h=ht0 * (1 - t / tf) + htf * t / tf,
            v=vt0 * (1 - t / tf) + vtf * t / tf,
            gamma=gammat0 * (1 - t / tf) + gammatf * t / tf,
            psi=np.deg2rad(90.0), t=t)
        TrajIG.append(X)

    phase = ode.phase("LGL3", TrajIG, 40)
    del units  # autoscaling destabilizes this problem (diverges on the
    # probed row scales); run unscaled like the baseline example
    phase.addBoundaryValue("Front", ["h", "theta", "v", "gamma", "psi",
                                     "t"], np.asarray(TrajIG[0])[0:6])
    phase.addLUVarBounds("Path", ["theta", "gamma"],
                         np.deg2rad(-89.0), np.deg2rad(89.0), 1.0)
    phase.addLUVarBound("Path", "alpha", np.deg2rad(-90.0),
                        np.deg2rad(90.0), 1.0)
    phase.addLUVarBound("Path", "beta", np.deg2rad(-90.0),
                        np.deg2rad(1.0), 1.0)
    phase.addUpperDeltaTimeBound(tmax, 1.0)
    phase.addBoundaryValue("Back", ["h", "v", "gamma"],
                           [htf, vtf, gammatf])
    phase.addDeltaVarObjective("theta", -1.0)
    phase.optimizer.set_SoeLSMode("L1")
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.PrintLevel = print_level
    phase.solve_optimize()
    phase.refineTrajManual(200)
    phase.optimize()
    Traj1 = phase.returnTraj()
    print("unconstrained crossrange (deg):",
          np.rad2deg(Traj1[-1][1]), "(Betts: 34.141)")

    Traj2 = None
    if heat_constrained:
        phase.addUpperFuncBound("Path", heating_rate(),
                                ["h", "v", "alpha"], Qlimit, 1 / Qlimit)
        phase.optimize()
        Traj2 = phase.returnTraj()
        print("heat-constrained crossrange (deg):",
              np.rad2deg(Traj2[-1][1]), "(Betts: 30.63)")
    return Traj1, Traj2


if __name__ == "__main__":
    run()
