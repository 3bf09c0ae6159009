"""CR3BP periodic-orbit continuation: L1 Lyapunov and Northern L1 Halo
families (reference `examples/OrbitContinuation.py`).

Re-designed for the TPU runtime: one phase object is reused across the whole
continuation sweep (`setTraj` + warm-started `solve` per family member), so
the transcription/factorization graph compiles once instead of once per
orbit."""

import numpy as np
import asset_asrl_torch as ast
from asset_asrl_torch.Astro.AstroModels import CR3BP
import asset_asrl_torch.Astro.Constants as c

oc = ast.OptimalControl
vf = ast.VectorFunctions

dt = 3.1415 / 10000

ode = CR3BP(c.MuEarth, c.MuMoon, c.LD)
mu = ode.mu
odeItg = ode.integrator(dt)


def make_phase(nSeg=64, tol=1e-12):
    odePhase = ode.phase("LGL3")
    odePhase.optimizer.set_EContol(tol)
    odePhase.optimizer.PrintLevel = 2
    odePhase._nSeg = nSeg
    return odePhase


def solvePeriodic(odePhase, ig, tf, fixInit=(0, 1, 2), first=False):
    trajGuess = odeItg.integrate_dense(ig, tf, 300)
    odePhase.setTraj(trajGuess, odePhase._nSeg)
    if first:
        # constraints are added once; subsequent sweeps update the pinned
        # values through subVariables (no retranscription)
        odePhase.addValueLock("Front", list(fixInit))
        odePhase.addBoundaryValue("Front", [1, 3, 6], [0.0, 0.0, 0.0])
        odePhase.addBoundaryValue("Back", [1, 3, 5], [0.0, 0.0, 0.0])
    else:
        odePhase.subVariables("Front", list(fixInit),
                              [ig[i] for i in fixInit])
    odePhase.solve()
    return odePhase.returnTraj()


def contin(odePhase, ig, tf, cIdx, dx, lim, fixInit=(0, 1, 2)):
    trajList = [solvePeriodic(odePhase, ig, tf, fixInit)]
    sign = np.sign(trajList[-1][0][cIdx] - lim)
    signLast = sign
    while sign == signLast:
        g = np.copy(trajList[-1][0])
        t = np.copy(trajList[-1][-1][6])
        g[cIdx] += dx
        sol = solvePeriodic(odePhase, g, t, fixInit)
        trajList.append([np.array(r) for r in sol])
        signLast = sign
        sign = np.sign(trajList[-1][0][cIdx] - lim)
    return trajList


def lyapunov_family(dx=-0.004, lim=0.79):
    ig = np.zeros(7)
    ig[0], ig[4] = 0.8234, 0.1263
    phase = make_phase()
    tj = solvePeriodic(phase, ig, 1.3, first=True)
    return contin(phase, tj[0], tj[-1][6], cIdx=0, dx=dx, lim=lim)


def halo_family(dx=0.004, lim=0.214):
    ig = np.zeros(7)
    ig[0], ig[4] = 0.8234, 0.1263
    phase = make_phase()
    tj = solvePeriodic(phase, ig, 1.3715, fixInit=(1, 2, 5), first=True)
    return contin(phase, tj[0], tj[-1][6], cIdx=2, dx=dx, lim=lim,
                  fixInit=(1, 2, 5))


if __name__ == "__main__":
    tl = lyapunov_family()
    print(f"L1 Lyapunov family: {len(tl)} orbits, "
          f"x0 range [{tl[-1][0][0]:.4f}, {tl[0][0][0]:.4f}]")
    th = halo_family()
    print(f"Northern L1 Halo family: {len(th)} orbits, "
          f"z0 up to {th[-1][0][2]:.4f}")
