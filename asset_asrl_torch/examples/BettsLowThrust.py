"""LEO->MEO low-thrust transfer with zonal harmonics (J2-J4), example 6 of
Betts, "Practical Methods for Optimal Control and Estimation Using
Nonlinear Programming" (reference `examples/BettsLowThrust.py`): MEE + weight
dynamics, RTN thrust direction with unit-norm path constraint, static
throttle ODE parameter, maximize final weight."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

g0 = 32.174
W = 1
mu_e = 1.407645794e16

Lstar = 20925662.73
Tstar = Lstar / np.sqrt(mu_e / Lstar)
Mstar = W / g0
Fstar = Mstar * Lstar / (Tstar ** 2)
Astar = Lstar / (Tstar ** 2)
Mustar = (Lstar ** 3) / (Tstar ** 2)

Re = 20925662.73 / Lstar
mu = mu_e / Mustar
Thrust = 4.446618e-3 / Fstar
Isp = 450 / Tstar
gs = g0 / Astar

J2, J3, J4 = 1082.639e-6, -2.565e-6, -1.608e-6
pt0 = 21837080.052835 / Lstar
ptf = 40007346.015232 / Lstar


def RTNBasisFunc():
    R, V = Args(6).tolist([(0, 3), (3, 3)])
    Rhat = R.normalized()
    Nhat = R.cross(V).normalized()
    That = Nhat.cross(R).normalized()
    return vf.stack(Rhat, That, Nhat)


def MEECartFunc(mu):
    X = Args(6)
    p, f, g, h, k, L = X.tolist()
    sinL, cosL = vf.sin(L), vf.cos(L)
    sqp = vf.sqrt(mu / p)
    w = 1 + f * cosL + g * sinL
    s2 = 1 + h ** 2 + k ** 2
    a2 = h ** 2 - k ** 2
    r = p / w
    r_s2 = r / s2
    subs2 = 1.0 / s2
    R = r_s2 * vf.stack([cosL + a2 * cosL + 2. * h * k * sinL,
                         sinL - a2 * sinL + 2. * h * k * cosL,
                         2.0 * (h * sinL - k * cosL)])
    V = -subs2 * sqp * vf.stack(
        [sinL + a2 * sinL - 2. * h * k * cosL + g - 2. * f * h * k + a2 * g,
         -cosL + a2 * cosL + 2. * h * k * sinL - f + 2. * g * h * k + a2 * f,
         -2.0 * (h * cosL + k * sinL + f * h + g * k)])
    return vf.stack([R, V])


def RadFunc(mu):
    X = Args(6)
    p, f, g, h, k, L = X.tolist()
    w = 1. + f * vf.cos(L) + g * vf.sin(L)
    return p / w


def ZonalGrav(mu, Re, J2, J3, J4):
    """Zonal-harmonic gravity (Betts eq. 6.46-6.49) in RTN, as a function
    of cartesian position/velocity."""
    X = Args(6)
    R, V = X.tolist([(0, 3), (3, 3)])
    r = R.norm()
    Ir = R.normalized()
    North = np.array([0, 0, 1.0])
    In = (North - Ir * (Ir.dot(North))).normalized()
    sphi = Ir[2]
    cphi = vf.sqrt(1 - sphi ** 2)
    P2 = 0.5 * (3.0 * (sphi ** 2) - 1.0)
    P3 = 0.5 * (5.0 * (sphi ** 3) - 3 * sphi)
    P4 = (35 / 8) * (sphi ** 4) - (30 / 8) * (sphi ** 2) + 3 / 8
    D2 = 3 * sphi
    D3 = 0.5 * (15.0 * (sphi ** 2) - 3.0)
    D4 = (35 / 2) * (sphi ** 3) - (30 / 4) * sphi
    Js, Ps, Ds = [J2, J3, J4], [P2, P3, P4], [D2, D3, D4]
    gns, grs = [], []
    for k in range(2, 5):
        gns.append(Ds[k - 2] * Js[k - 2] * ((Re / r) ** k))
        grs.append(((k + 1) * Ps[k - 2] * Js[k - 2]) * ((Re / r) ** k))
    gn = vf.sum(gns) * cphi
    gr = vf.sum(grs)
    Gcart = (gn * In - gr * Ir) * (-mu / R.squared_norm())
    M = vf.RowMatrix(RTNBasisFunc(), 3, 3)
    return M * Gcart


def MEEDynamicsRTN(mu):
    """MEE EOMs with RTN perturbing acceleration appended to the input."""
    X = Args(9)
    p, f, g, h, k, L, ur, ut, un = X.tolist()
    sinL, cosL = vf.sin(L), vf.cos(L)
    sqp = vf.sqrt(p) / np.sqrt(mu)
    hk = X.segment2(3)
    w = 1. + f * cosL + g * sinL
    s2 = 1. + hk.squared_norm()
    pdot = 2. * (p / w) * ut
    fdot = vf.sum([ur * sinL, ((w + 1) * cosL + f) * (ut / w),
                   -(h * sinL - k * cosL) * (g * un / w)])
    gdot = vf.sum([-ur * cosL, ((w + 1) * sinL + g) * (ut / w),
                   (h * sinL - k * cosL) * (f * un / w)])
    hkdot = vf.stack([cosL, sinL]) * ((s2 * un / w) / 2.0)
    Ldot = mu * (w / p) * (w / p) + (1.0 / w) * (h * sinL - k * cosL) * un
    return vf.stack([pdot, fdot, gdot, hkdot, Ldot]) * sqp


class LTModel(oc.ODEBase):
    def __init__(self, mu, T, gs, Isp, Re, J2=False):
        XtUP = oc.ODEArguments(7, 3, 1)
        MEEs = XtUP.XVec().head(6)
        ww = XtUP.XVar(6)
        U = XtUP.UVec().head3().normalized()
        tau = XtUP.PVar(0)
        wwdot = -T * (1 + .01 * tau) / Isp
        acc_T = gs * T * (1 + .01 * tau) * U / ww
        acc_J2 = ZonalGrav(mu, Re, J2, J3, J4)(MEECartFunc(mu))(MEEs)
        acc = acc_T + acc_J2
        Xdot = MEEDynamicsRTN(mu)(vf.stack(MEEs, acc))
        super().__init__(vf.stack([Xdot, wwdot]), 7, 3, 1)


def EqBCon():
    X = Args(6)
    p, f, g, h, k, L = X.tolist()
    eq1 = p - ptf
    eq2 = X.segment2(1).squared_norm() - .73550320568829 ** 2
    eq3 = X.segment2(3).squared_norm() - .61761258786099 ** 2
    eq4 = f * h + g * k
    return vf.stack([eq1, eq2, eq3, eq4])


def IqBCon():
    X = Args(6)
    p, f, g, h, k, L = X.tolist()
    return g * h - k * f


def run(nsegs=16, adaptive=True, print_level=1):
    X0 = np.zeros(12)
    X0[0] = pt0
    X0[3] = -0.25396764647494
    X0[5] = np.pi
    X0[6] = 1 / Fstar
    X0[8:11] = [0, 1, 0]
    X0[11] = -25

    ode = LTModel(mu, Thrust, gs, Isp, Re, J2)
    tfig = 90000 / Tstar

    def Prograde():
        RV = MEECartFunc(mu)
        RTNBasis = RTNBasisFunc()(RV)
        U = vf.RowMatrix(RTNBasis, 3, 3) * RV.tail(3).normalized()
        return U

    integ = ode.integrator(.1, Prograde(), range(0, 6))
    IG = integ.integrate_dense(X0, tfig)

    phase = ode.phase("LGL5", IG, nsegs)
    phase.addBoundaryValue("Front", range(0, 8), X0[0:8])
    phase.addEqualCon("Path", Args(3).norm() - 1, [8, 9, 10])
    phase.setControlMode("NoSpline")
    phase.addLUFuncBound("Path", RadFunc(mu), range(0, 6), Re, 10 * Re)
    phase.addEqualCon("Back", EqBCon(), range(0, 6))
    phase.addInequalCon("Back", IqBCon(), range(0, 6))
    phase.addLUVarBound("ODEParams", 0, -50, 0)
    phase.addLowerVarBound("Back", 6, .05)
    phase.addValueObjective("Back", 6, -1.0)
    phase.optimizer.PrintLevel = print_level
    phase.optimizer.set_EContol(1.0e-9)
    if adaptive:
        phase.setAdaptiveMesh(True)
        phase.setMeshErrorEstimator("integrator")
        phase.setMeshTol(1.0e-7)
    flag = phase.optimize_solve()

    Traj = phase.returnTraj()
    FinalWeight = Traj[-1][6] * Fstar
    FinalTime = Traj[-1][7] * Tstar
    ThrottleParam = phase.returnStaticParams() if False else Traj[-1][-1]
    print(f"Final Weight:{FinalWeight} lb")
    print(f"Final Time:{FinalTime} s")
    return flag, FinalWeight, Traj


if __name__ == "__main__":
    run()
