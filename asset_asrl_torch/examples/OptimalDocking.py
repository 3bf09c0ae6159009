"""Minimum-time docking with a tumbling target (reference
`examples/OptimalDocking.py`, after Michael/Chudej/Gerdts/Panncek 2013).

Form1 carries the uncontrolled target attitude in the state; Form2
eliminates it and uses a torque-free propagation + interp table as a
time-dependent rendezvous boundary condition (smaller and faster)."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments

Lstar, Tstar, Mstar = 10.0, 30.0, 10.0
Astar = Lstar / Tstar ** 2
Fstar = Astar * Mstar
Mustar = Lstar ** 3 / Tstar ** 2

a = 7071000 / Lstar
mu = 3.986e14 / Mustar
n = np.sqrt(mu / a ** 3)
m = 100 / Mstar
MaxThrust = .1 / Fstar
MaxTorque = 1 / (Fstar * Lstar)
Srad = 1 / Lstar
Udvec = np.array([0, 1.01, 0]) / Lstar
Ivec = np.array([1000, 2000, 1000]) / (Mstar * Lstar * Lstar)


class RelDynModel(oc.ODEBase):
    """Clohessy-Wiltshire translation + rigid-body attitude of servicer AND
    target (20 states, 6 controls)."""

    def __init__(self, I1, I2, n, m):
        args = oc.ODEArguments(20, 6)
        X = args.XVec().head3()
        V = args.XVec().segment3(3)
        q = args.XVec().segment(6, 4).normalized()
        w = args.XVec().segment3(10)
        p = args.XVec().segment(13, 4).normalized()
        phi = args.XVec().segment3(17)
        Thrust = args.UVec().head3()
        Torque = args.UVec().tail3()

        Xdot = V
        Vdoto = vf.stack([2 * n * V[1] + (3 * n ** 2) * X[0],
                          -2 * n * V[0],
                          -(n ** 2) * X[2]])
        Vdot = Vdoto + vf.quatRotate(q, Thrust) / m
        qdot = vf.quatProduct(q, w.padded_lower(1)) / 2.0
        L1 = w.cwiseProduct(I1)
        wdot = (L1.cross(w) + Torque).cwiseQuotient(I1)
        pdot = vf.quatProduct(p, phi.padded_lower(1)) / 2.0
        L2 = phi.cwiseProduct(I2)
        phidot = (L2.cross(phi)).cwiseQuotient(I2)
        super().__init__(vf.stack([Xdot, Vdot, qdot, wdot, pdot, phidot]),
                         20, 6)


class RelDynModel2(oc.ODEBase):
    """Servicer only (13 states, 6 controls)."""

    def __init__(self, I1, n, m):
        args = oc.ODEArguments(13, 6)
        X = args.XVec().head3()
        V = args.XVec().segment3(3)
        q = args.XVec().segment(6, 4).normalized()
        w = args.XVec().segment3(10)
        Thrust = args.UVec().head3()
        Torque = args.UVec().tail3()
        Xdot = V
        Vdoto = vf.stack([2 * n * V[1] + (3 * n ** 2) * X[0],
                          -2 * n * V[0],
                          -(n ** 2) * X[2]])
        Vdot = Vdoto + vf.quatRotate(q, Thrust) / m
        qdot = vf.quatProduct(q, w.padded_lower(1)) / 2.0
        L1 = w.cwiseProduct(I1)
        wdot = (L1.cross(w) + Torque).cwiseQuotient(I1)
        super().__init__(vf.stack([Xdot, Vdot, qdot, wdot]), 13, 6)


class TorqueFree(oc.ODEBase):
    def __init__(self, I2):
        args = oc.ODEArguments(7, 0)
        p = args.XVec().head(4).normalized()
        phi = args.XVec().segment3(4)
        pdot = vf.quatProduct(p, phi.padded_lower(1)) / 2.0
        L2 = phi.cwiseProduct(I2)
        phidot = (L2.cross(phi)).cwiseQuotient(I2)
        super().__init__(vf.stack([pdot, phidot]), 7, 0)


def RendCon(ud):
    X, V, q, w, p, phi = Args(20).tolist(
        [(0, 3), (3, 3), (6, 4), (10, 3), (13, 4), (17, 3)])
    q = q.normalized()
    p = p.normalized()
    Xdq = vf.quatRotate(q, ud)
    vdq = vf.quatRotate(q, w)
    Vdq = -1.0 * Xdq.cross(vdq)
    Xdp = vf.quatRotate(p, ud)
    vdp = vf.quatRotate(p, phi)
    Vdp = -1.0 * Xdp.cross(vdp)
    return vf.stack([X + Xdq - Xdp, V + Vdq - Vdp])


def RendCon2(ud, tab):
    func = oc.InterpFunction(tab, range(0, 7))
    X, V, q, w, t = Args(14).tolist(
        [(0, 3), (3, 3), (6, 4), (10, 3), (13, 1)])
    return RendCon(ud)(X, V, q, w, func(t))


def Form2(nsegs=192, print_level=1):
    ode_torquefree = TorqueFree(Ivec)
    integ_torquefree = ode_torquefree.integrator(.01)
    SimTime = 600 / Tstar
    TIS = np.zeros(8)
    TIS[0] = .05
    TIS[3] = np.sqrt(1 - TIS[0] ** 2)
    TIS[5] = .0349 * Tstar
    TIS[6] = .017453 * Tstar
    TargetTraj = integ_torquefree.integrate_dense(TIS, SimTime, 2000)
    TargetTab = oc.LGLInterpTable(ode_torquefree.vf(), 7, 0, TargetTraj)

    X0 = np.zeros(20)
    X0[1] = -10.0 / Lstar
    X0[9] = 1
    X0[14] = -MaxThrust
    X0[15] = MaxThrust
    X0[19] = -MaxTorque / 4

    ode = RelDynModel2(Ivec, n, m)
    integ = ode.integrator(.01)
    Traj = integ.integrate_dense(X0, 200 / Tstar, 1000)

    phase = ode.phase("LGL3", Traj, nsegs)
    phase.setControlMode("BlockConstant")
    phase.addBoundaryValue("Front", range(0, 14), X0[0:14])
    phase.addLUVarBounds("Path", [14, 15, 16], -MaxThrust, MaxThrust, .1)
    phase.addLUVarBounds("Path", [17, 18, 19], -MaxTorque, MaxTorque, 1)
    phase.addLowerNormBound("Path", [0, 1, 2], 2 * Srad, 1.0)
    phase.addEqualCon("Last", RendCon2(Udvec, TargetTab), range(0, 14))
    phase.addUpperDeltaTimeBound(SimTime)
    phase.addDeltaTimeObjective(1.0)
    phase.optimizer.set_BoundFraction(.995)
    phase.optimizer.set_PrintLevel(print_level)
    flag = phase.optimize()
    Traj = phase.returnTraj()
    tf = Traj[-1][13] * Tstar
    print("Form2 Final Time:", tf, "s")
    return flag, tf, Traj


def Form1(nsegs=192, print_level=1):
    X0 = np.zeros(27)
    X0[1] = -10.0 / Lstar
    X0[9] = 1
    X0[13] = .05
    X0[16] = np.sqrt(1 - X0[13] ** 2)
    X0[18] = .0349 * Tstar
    X0[19] = .017453 * Tstar
    X0[21] = -MaxThrust
    X0[22] = MaxThrust
    X0[26] = -MaxTorque / 4

    ode = RelDynModel(Ivec, Ivec, n, m)
    integ = ode.integrator(.01)
    IG = integ.integrate_dense(X0, 200 / Tstar, 1000)

    phase = ode.phase("LGL3", IG, nsegs)
    phase.setControlMode("BlockConstant")
    phase.addBoundaryValue("Front", range(0, 21), X0[0:21])
    phase.addLUVarBounds("Path", [21, 22, 23], -MaxThrust, MaxThrust, .1)
    phase.addLUVarBounds("Path", [24, 25, 26], -MaxTorque, MaxTorque, 1)
    phase.addLowerNormBound("Path", [0, 1, 2], 2 * Srad, 1.0)
    phase.addEqualCon("Back", RendCon(Udvec), range(0, 20))
    phase.addDeltaTimeObjective(1.0)
    phase.optimizer.set_BoundFraction(.995)
    phase.optimizer.set_PrintLevel(print_level)
    flag = phase.optimize()
    Traj = phase.returnTraj()
    tf = Traj[-1][20] * Tstar
    print("Form1 Final Time:", tf, "s")
    return flag, tf, Traj


if __name__ == "__main__":
    Form2()
    Form1()
