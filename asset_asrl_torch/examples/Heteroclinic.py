"""Heteroclinic connection between L1 and L2 Lyapunov orbits in the
Earth-Moon CR3BP (reference `examples/Heteroclinic.py`).

Pipeline: solve the two periodic orbits at a fixed Jacobi constant ->
propagate stable/unstable manifold fans with the *vmapped, event-stopping*
integrator (crossing of the Moon's x-plane, culled on lunar close
encounters / departure) -> pick the closest pair -> join the two arcs in a
2-phase OCP with interp-table boundary conditions tying the endpoints to
the orbits."""

import numpy as np
import asset_asrl_torch as ast
from asset_asrl_torch.Astro.AstroModels import CR3BP
import asset_asrl_torch.Astro.Constants as c

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


def normalize(x):
    return np.array(x) / np.linalg.norm(x)


def JacobiFunc(mu):
    r, v = Args(6).tolist([(0, 3), (3, 3)])
    p1loc = np.array([-mu, 0, 0])
    p2loc = np.array([1.0 - mu, 0, 0])
    gt1 = (r - p1loc).inverse_norm() * (1.0 - mu)
    gt2 = (r - p2loc).inverse_norm() * mu
    return r.head2().squared_norm() + (gt1 + gt2) * 2 - v.squared_norm()


def MakeOrbit(ode, OrbitIG, Jconst, nsegs=60):
    phase = ode.phase("LGL5", OrbitIG, nsegs)
    phase.addBoundaryValue("First", [1, 2, 3, 5, 6], [0, 0, 0, 0, 0])
    phase.addBoundaryValue("Last", [1, 3], [0, 0])
    phase.addEqualCon("First", JacobiFunc(ode.mu) - Jconst, range(0, 6))
    phase.optimizer.set_EContol(1.0e-12)
    phase.optimizer.PrintLevel = 2
    phase.solve()
    return phase.returnTraj()


def GetManifold(ode, OrbitIn, dx, dt, nman=40, Stable=True):
    integ = ode.integrator("DOPRI87", .01)
    integ.setAbsTol(1.0e-13)
    Period = OrbitIn[-1][6]
    Orbit = integ.integrate_dense(OrbitIn[0], Period, nman)
    times = [O[6] + Period for O in Orbit]
    StmResults = integ.integrate_stm_parallel(Orbit, times)

    EigIGs = []
    for i, (Xf, Jac) in enumerate(StmResults):
        vals, vecs = np.linalg.eig(Jac[0:6, 0:6])
        vecs = vecs.T
        idxs = sorted(range(6), key=lambda k: np.abs(vals[k]))
        Vec = np.real(vecs[idxs[0]] if Stable else vecs[idxs[-1]])
        for sgn in (+1, -1):
            Xp = np.copy(Orbit[i])
            Xp[0:3] += sgn * normalize(Vec[0:3]) * dx
            EigIGs.append(Xp)
    if Stable:
        dt = -dt
    ts = [IG[6] + dt for IG in EigIGs]

    X = Args(7)
    CrossMoon = X[0] - (1 - ode.mu)
    alt = (X.head3() - ode.P2).norm() - .015
    Cull = alt * ((X[1] - .15) * (X[1] + .15))
    events = [(CrossMoon, 0, 1), (Cull, 0, 1)]

    Results = integ.integrate_dense_parallel(EigIGs, ts, events)
    Manifolds = []
    for Traj, eventlocs in Results:
        if len(eventlocs[0]) == 1 and len(eventlocs[1]) == 0:
            Traj[-1] = eventlocs[0][0]
            Manifolds.append(Traj)
    return Manifolds


def FindClosestConnection(Orbs1, Orbs2):
    distij = []
    for i in range(len(Orbs1)):
        for j in range(len(Orbs2)):
            dist = np.linalg.norm(Orbs1[i][-1][0:6] - Orbs2[j][-1][0:6])
            distij.append([dist, i, j])
    distij.sort(key=lambda x: x[0])
    return Orbs1[distij[0][1]], Orbs2[distij[0][2]]


def MakeHeteroclinic(ode, Man1, Man2, L1Orbit, L2Orbit, nsegs=40):
    OrbitTab1 = oc.LGLInterpTable(L1Orbit)
    OrbitTab1.makePeriodic()
    OrbitTab2 = oc.LGLInterpTable(L2Orbit)
    OrbitTab2.makePeriodic()

    def PosCon(OrbitTab):
        PosFunc = oc.InterpFunction(OrbitTab, range(0, 3))
        Rt = Args(4)
        return Rt.head(3) - PosFunc(Rt[3])

    def DVObj(OrbitTab):
        VelFunc = oc.InterpFunction(OrbitTab, range(3, 6))
        Vt = Args(4)
        return (Vt.head(3) - VelFunc(Vt[3])).squared_norm()

    phase1 = ode.phase("LGL7", Man1[1:], nsegs)
    phase1.addLowerVarBound("Front", 6, -L1Orbit[-1][6])
    phase1.addUpperVarBound("Front", 6, 2 * L1Orbit[-1][6])
    phase1.addEqualCon("First", PosCon(OrbitTab1), [0, 1, 2, 6])
    phase1.addStateObjective("First", DVObj(OrbitTab1), [3, 4, 5, 6])

    phase2 = ode.phase("LGL7", Man2[0:-1], nsegs)
    phase2.addEqualCon("Last", PosCon(OrbitTab2), [0, 1, 2, 6])
    phase2.addStateObjective("Last", DVObj(OrbitTab2), [3, 4, 5, 6])
    phase1.addLowerVarBound("Last", 6, -L2Orbit[-1][6])
    phase1.addUpperVarBound("Last", 6, 2 * L2Orbit[-1][6])

    ocp = oc.OptimalControlProblem()
    ocp.addPhase(phase1)
    ocp.addPhase(phase2)
    ocp.addForwardLinkEqualCon(phase1, phase2, range(0, 6))
    ocp.optimizer.set_EContol(1.0e-9)
    ocp.optimizer.set_OptLSMode("L1")
    ocp.optimizer.PrintLevel = 1
    ocp.optimize()

    Traj1 = phase1.returnTraj()
    Traj2 = phase2.returnTraj()
    DV1 = np.linalg.norm(Traj1[0][3:6] - OrbitTab1(Traj1[0][6])[3:6])
    DV2 = np.linalg.norm(Traj2[-1][3:6] - OrbitTab2(Traj2[-1][6])[3:6])
    print("Total DV:", (DV1 + DV2) * ode.vstar)
    return Traj1, Traj2, (DV1 + DV2) * ode.vstar


def main(Jconst=3.15, dx=1.0e-5, dt=12.0, nman=40, nsegs=60):
    ode = CR3BP(c.MuEarth, c.MuMoon, c.LD)
    L1OrbitIG = ode.GenL1Lissajous(.03, 0, 180, 0, 1, 100)
    L2OrbitIG = ode.GenL2Lissajous(.03, 0, 0, 0, 1, 100)
    L1Orbit = MakeOrbit(ode, L1OrbitIG, Jconst, nsegs)
    L2Orbit = MakeOrbit(ode, L2OrbitIG, Jconst, nsegs)
    UnstableL1 = GetManifold(ode, L1Orbit, dx, dt, nman, False)
    StableL2 = GetManifold(ode, L2Orbit, dx, dt, nman, True)
    print(f"manifolds: {len(UnstableL1)} unstable, {len(StableL2)} stable")
    Traj1IG, Traj2IG = FindClosestConnection(UnstableL1, StableL2)
    Traj2IG = Traj2IG[::-1]
    return MakeHeteroclinic(ode, Traj1IG, Traj2IG, L1Orbit, L2Orbit)


if __name__ == "__main__":
    Traj1, Traj2, DV = main()
    print(f"heteroclinic connection: {len(Traj1)}+{len(Traj2)} nodes, "
          f"DV = {DV:.3f} m/s")
