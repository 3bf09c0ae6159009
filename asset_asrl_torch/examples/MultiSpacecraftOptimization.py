"""N-spacecraft rendezvous constellation (reference
`examples/MultiSpacecraftOptimization.py:69-121`): N low-thrust phases whose
terminal states are all linked to a shared free set-point carried as OCP
link parameters, swept over initial phase-angle spreads by a continuation
loop that substitutes locked initial conditions with subVariables (no
retranscription between members)."""

import time
import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments


class TwoBody(oc.ODEBase):
    def __init__(self, P1mu, ltacc=False):
        Xvars, Uvars = 6, (3 if ltacc else 0)
        args = oc.ODEArguments(Xvars, Uvars)
        r = args.head3()
        v = args.segment3(3)
        g = r.normalized_power3() * (-P1mu)
        acc = g + args.tail3() * ltacc if ltacc else g
        super().__init__(vf.stack([v, acc]), Xvars, Uvars)


def MakeCircIG(r, thetadeg):
    v = np.sqrt(1.0 / r)
    theta = np.deg2rad(thetadeg)
    IGC = np.zeros(7)
    IGC[0] = np.cos(theta) * r
    IGC[1] = np.sin(theta) * r
    IGC[3] = -np.sin(theta) * v
    IGC[4] = np.cos(theta) * v
    return IGC


def MakeCircTraj(r, thetadeg, tf, n):
    ode = TwoBody(1)
    integ = ode.integrator(.01)
    IGC = MakeCircIG(r, thetadeg)
    Temp = integ.integrate_dense(IGC, tf, n)
    Traj = []
    for T in Temp:
        TT = np.zeros(10)
        TT[0:7] = T[0:7]
        TT[7:10] = 0.01
        Traj.append(TT)
    return Traj


def MultSpaceCraft(Trajs, IStates, SetPointIG, LTacc=0.01, NSegs=32,
                   print_level=2):
    ocp = oc.OptimalControlProblem()
    ode = TwoBody(1, LTacc)

    for i, T in enumerate(Trajs):
        phase = ode.phase("LGL5")
        phase.setTraj(T, NSegs)
        phase.setControlMode("BlockConstant")
        phase.addValueLock("Front", range(0, 7))
        phase.addLUNormBound("Path", [7, 8, 9], 0.01, 1.0, 1)
        phase.addDeltaTimeObjective(1.0)
        ocp.addPhase(phase)

    # terminal state+time of every phase == the free link-param set point
    ocp.setLinkParams(SetPointIG[0:7])
    LinkFun = Args(14).head(7) - Args(14).tail(7)
    for i in range(len(Trajs)):
        ocp.addLinkEqualCon(LinkFun, [(i, "Back", range(0, 7), [], [])],
                            range(0, 7))
    # set-point position/velocity orthogonality (circular-orbit condition)
    ocp.addLinkParamEqualCon(Args(6).head3().dot(Args(6).tail3()),
                             range(0, 6))

    ocp.optimizer.set_OptLSMode("L1")
    ocp.optimizer.set_deltaH(5.0e-8)
    ocp.optimizer.set_KKTtol(1.0e-9)
    ocp.optimizer.set_BoundFraction(0.997)
    ocp.optimizer.PrintLevel = print_level
    ocp.optimizer.set_MaxLSIters(1)

    Data = []
    for j, Ist in enumerate(IStates):
        for i, phase in enumerate(ocp.Phases):
            phase.subVariables("Front", range(0, 7), Ist[i][0:7])
        if j == 0:
            ocp.solve()
        t0 = time.perf_counter()
        Flag = ocp.optimize()
        tf = time.perf_counter()
        if print_level <= 1:
            print(f"  member {j}: {(tf - t0) * 1000.0:.1f} ms")
        if Flag == ast.Solvers.ConvergenceFlags.NOTCONVERGED:
            ocp.solve_optimize()
        Data.append([[phase.returnTraj() for phase in ocp.Phases],
                     ocp.returnLinkParams()])
    return Data


def main(n=4, nsweeps=3, print_level=2):
    Thetas = np.linspace(20, 60, nsweeps)
    TrajsIG = [MakeCircTraj(1, theta, 2.0 * np.pi, 100)
               for theta in np.linspace(0, Thetas[0], n)]
    SetPointIG = TrajsIG[int((n - 1) / 2)][-1][0:7]
    AllIGs = [[MakeCircIG(1, theta) for theta in np.linspace(0, Theta, n)]
              for Theta in Thetas]
    Data = MultSpaceCraft(TrajsIG, AllIGs, SetPointIG, 0.015,
                          print_level=print_level)
    return Data


if __name__ == "__main__":
    import os
    Data = main(n=int(os.environ.get("MSO_N", "4")),
                nsweeps=int(os.environ.get("MSO_SWEEPS", "3")),
                print_level=1)
    for j, D in enumerate(Data):
        print(f"sweep {j}: rendezvous time {D[1][6] / (2 * np.pi):.4f} rev")


def ensemble_demo(nscen=64, mesh=None, print_level=2):
    """Jet-analog scenario ensemble (SURVEY section 2.9 P4): `nscen`
    perturbed copies of one low-thrust rendezvous leg solved by ONE
    compiled vmapped FULL-PSIOPT program (`parallel.solve_ensemble`),
    optionally sharded over a device mesh.  Every lane reproduces what a
    separate phase.optimize() would return."""
    from asset_asrl_torch.parallel import solve_ensemble
    ode = TwoBody(1, ltacc=0.05)
    IG = [np.concatenate([row[:7], [0.01, 0, 0]])
          for row in MakeCircTraj(1, 0.0, np.pi, 40)]
    target = MakeCircIG(1.0, np.rad2deg(np.pi) + 4.0)
    phase = ode.phase("LGL3", IG, 12)
    phase.addBoundaryValue("Front", range(0, 7), np.asarray(IG[0][:7]))
    phase.addUpperNormBound("Path", [7, 8, 9], 1.0)
    phase.addBoundaryValue("Back", [6], [np.pi])
    phase.addEqualCon("Back", Args(6) - target[0:6], range(0, 6))
    phase.addIntegralObjective(Args(3).squared_norm(), [7, 8, 9])
    phase.optimizer.set_PrintLevel(print_level)
    flag0 = phase.optimize()      # baseline member
    base = np.asarray(phase.makeSolverInput())

    rng = np.random.default_rng(7)
    perts = [rng.normal(size=base.shape) * 1e-4 for _ in range(nscen)]
    t0 = time.time()
    res = solve_ensemble(phase, perturb_states=perts, mesh=mesh)
    dt = time.time() - t0
    conv = int(np.sum(res["flags"] == 0))
    print(f"ensemble: {conv}/{nscen} converged, "
          f"iters {res['iters'].min()}..{res['iters'].max()}, "
          f"{dt:.1f}s total")
    return res
