"""Delta III 4-phase ascent to GTO (reference `examples/Delta3Launch.py`;
Betts' launch problem).  Maximizes final mass; reference regression value
7529.75 kg."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

g0 = 9.80665
Lstar, Tstar, Mstar = 6378145, 961.0, 301454.0
Astar = Lstar / Tstar ** 2
Vstar = Lstar / Tstar
Rhostar = Mstar / Lstar ** 3
Mustar = Lstar ** 3 / Tstar ** 2
Fstar = Astar * Mstar

mu = 3.986012e14 / Mustar
Re = 6378145 / Lstar
We = 7.29211585e-5 * Tstar
RhoAir = 1.225 / Rhostar
h_scale = 7200 / Lstar
g = g0 / Astar
CD = .5
S = 4 * np.pi / Lstar ** 2

# stage thrust/isp/burn times (9 solid boosters + 2 liquid stages)
TS, T1, T2 = 628500 / Fstar, 1083100 / Fstar, 110094 / Fstar
IS, I1, I2 = 283.33364 / Tstar, 301.68 / Tstar, 467.21 / Tstar
tS, t1, t2 = 75.2 / Tstar, 261 / Tstar, 700 / Tstar
TMS, TM1, TM2, TMPay = (19290 / Mstar, 104380 / Mstar, 19300 / Mstar,
                        4164 / Mstar)
PMS, PM1, PM2 = 17010 / Mstar, 95550 / Mstar, 16820 / Mstar
SMS, SM1, SM2 = TMS - PMS, TM1 - PM1, TM2 - PM2

T_phase = [6 * TS + T1, 3 * TS + T1, T1, T2]
mdot_phase = [(6 * TS / IS + T1 / I1) / g, (3 * TS / IS + T1 / I1) / g,
              T1 / (g * I1), T2 / (g * I2)]
tf_phase = [tS, 2 * tS, t1, t1 + t2]
m0_1 = 9 * TMS + TM1 + TM2 + TMPay
mf_1 = m0_1 - 6 * PMS - (tS / t1) * PM1
m0_2 = mf_1 - 6 * SMS
mf_2 = m0_2 - 3 * PMS - (tS / t1) * PM1
m0_3 = mf_2 - 3 * SMS
mf_3 = m0_3 - (1 - 2 * tS / t1) * PM1
m0_4 = mf_3 - SM1
mf_4 = m0_4 - PM2
m0_phase = [m0_1, m0_2, m0_3, m0_4]
mf_phase = [mf_1, mf_2, mf_3, mf_4]


class RocketODE(oc.ODEBase):
    def __init__(self, T, mdot):
        XtU = oc.ODEArguments(7, 3)
        R = XtU.XVec().head3()
        V = XtU.XVec().segment3(3)
        m = XtU.XVar(6)
        u = XtU.UVec().normalized()
        h = R.norm() - Re
        rho = RhoAir * vf.exp(-h / h_scale)
        Vr = V + R.cross(np.array([0, 0, We]))
        D = (-0.5 * CD * S) * rho * (Vr * Vr.norm())
        Rdot = V
        Vdot = (-mu) * R.normalized_power3() + (T * u + D) / m
        super().__init__(vf.stack(Rdot, Vdot, -mdot), 7, 3)


def TargetOrbit(at, et, it, Ot, Wt):
    """Constrain the five slow classical elements at burnout."""
    R, V = Args(6).tolist([(0, 3), (3, 3)])
    r = R.norm()
    v = V.norm()
    hvec = R.cross(V)
    nvec = vf.cross([0, 0, 1], hvec)
    eps = 0.5 * (v ** 2) - mu / r
    a = -0.5 * mu / eps
    evec = V.cross(hvec) / mu - R.normalized()
    e = evec.norm()
    i = vf.arccos(hvec.normalized()[2])
    O = vf.arccos(nvec.normalized()[0])
    O = vf.ifelse(nvec[1] > 0, O, 2 * np.pi - O)
    W = vf.arccos(nvec.normalized().dot(evec.normalized()))
    W = vf.ifelse(evec[2] > 0, W, 2 * np.pi - W)
    return vf.stack([a, e, i, O, W]) - np.array([at, et, it, Ot, Wt])


def build_ocp(nsegs=40, print_level=1):
    at = 24361140 / Lstar
    et = .7308
    Ot = np.deg2rad(269.8)
    Wt = np.deg2rad(130.5)
    istart = np.deg2rad(28.5)

    y0 = np.zeros(6)
    y0[0:3] = np.array([np.cos(istart), 0, np.sin(istart)]) * Re
    y0[3:6] = -np.cross(y0[0:3], np.array([0, 0, We]))
    y0[3] += 0.00001 / Vstar
    yf = ast.Astro.classic_to_cartesian([at, et, istart, Ot, Wt, -.05], mu)

    ts = np.linspace(0, tf_phase[3], 1000)
    IGs = [[], [], [], []]
    bounds_t = [0] + tf_phase
    for t in ts:
        X = np.zeros(11)
        X[0:6] = y0 + (yf - y0) * (t / ts[-1])
        X[7] = t
        X[8:11] = [0, 1, 0]
        for ph in range(4):
            if bounds_t[ph] <= t < bounds_t[ph + 1] or \
                    (ph == 3 and t >= bounds_t[4]):
                frac = (t - bounds_t[ph]) / (bounds_t[ph + 1] - bounds_t[ph])
                X[6] = m0_phase[ph] + (mf_phase[ph] - m0_phase[ph]) * frac
                IGs[ph].append(X.copy())
                break

    odes = [RocketODE(T_phase[i], mdot_phase[i]) for i in range(4)]
    phases = []
    for i in range(4):
        p = odes[i].phase("LGL3", IGs[i], nsegs)
        p.setControlMode("HighestOrderSpline")
        p.addLUNormBound("Path", [8, 9, 10], .5, 1.5)
        if i == 0:
            p.addBoundaryValue("Front", range(0, 8), IGs[0][0][0:8])
            p.addLowerNormBound("Path", [0, 1, 2], Re * .999999)
        else:
            p.addLowerNormBound("Path", [0, 1, 2], Re)
            p.addBoundaryValue("Front", [6], [m0_phase[i]])
        if i < 3:
            p.addBoundaryValue("Back", [7], [tf_phase[i]])
        phases.append(p)

    phases[3].addUpperVarBound("Back", 7, tf_phase[3], 1.0)
    phases[3].addEqualCon("Back", TargetOrbit(at, et, istart, Ot, Wt),
                          range(0, 6))
    phases[3].addValueObjective("Back", 6, -1.0)

    ocp = oc.OptimalControlProblem()
    for p in phases:
        ocp.addPhase(p)
    ocp.addForwardLinkEqualCon(phases[0], phases[3],
                               [0, 1, 2, 3, 4, 5, 7, 8, 9, 10])
    ocp.optimizer.set_OptLSMode("L1")
    ocp.optimizer.set_SoeLSMode("L1")
    ocp.optimizer.set_MaxLSIters(2)
    ocp.optimizer.PrintLevel = print_level
    return ocp


if __name__ == "__main__":
    ocp = build_ocp()
    phases = ocp.Phases
    ocp.solve_optimize()
    mfinal = phases[3].returnTraj()[-1][6] * Mstar
    print("final mass (kg):", mfinal, "(reference 7529.75)")

    try:
        import matplotlib.pyplot as plt
        for i, p in enumerate(phases):
            TT = np.array(p.returnTraj()).T
            h = (np.linalg.norm(TT[0:3], axis=0) - Re) * Lstar / 1000
            plt.plot(TT[7] * Tstar, h, label=f"phase {i + 1}")
        plt.xlabel("t (s)"); plt.ylabel("altitude (km)")
        plt.grid(True); plt.legend(); plt.show()
    except ImportError:
        pass
