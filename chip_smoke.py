#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`asset_asrl_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. device: a CUDA card must be visible; prints its name, power limit and
   the torch / CUDA versions;
2. build: compiles kernel K1 (`asset_asrl_torch/csrc/gj_inverse.cu`,
   `gj_inverse_wide.cu`) and prints what `ptxas -v` reported;
3. K1 against its plain PyTorch versions on seeded symmetric
   quasi-definite blocks, f64 and f32: the narrow kernels at the
   block-cyclic-reduction shapes of the 10^4-node problems, the wide
   (blocked) kernel at border widths 65 to 1029 against both the
   unblocked and the blocked plain version; the fused bad-pivot count
   against the plain count, also on blocks with a zero and a NaN pivot;
   a second run bitwise equal to the first; each kernel timed at several
   shapes beside its bound, its plain version and `torch.linalg.inv_ex`;
4. BCR factor/solve on the card against a dense solve and eigvalsh
   inertia;
5. the CartPole swing-up (LGL5, 40 segments) through `phase.optimize()`
   against its known flag / iterations / objective, and a bitwise
   repeatability check of one factorization;
6. the same problem at 5000 segments (10,001 collocation nodes), with
   time-to-solution, iterations/s and peak device memory;
7. single-phase breadth: the Brachistochrone under all five
   transcriptions and the CartPole in the BlockConstant and
   HighestOrderSpline control modes, against the JAX package's flags,
   iterations and objectives;
8. formation flying (two phases, PathToPath link) at 80, 256 and 512
   segments per phase: the border (segments + 5 wide) goes through the
   wide K1 kernel;
9. the 4-phase Delta III launch at 40 segments per phase through
   `ocp.solve_optimize()`, and a bitwise repeatability check of one
   factorization;
10. Delta III at 2500 segments per phase (10,004 nodes), with
   time-to-solution, iterations/s and peak device memory;
11. the integrator: 4096 seeded two-body rows over one period each with
   DOPRI87 in one batched call (against the port's own CPU run of 16 of
   them, the JAX package's numbers for 4 of them, and the closed orbit),
   the state-transition matrices of 256 of them, and a batch of
   periapsis-crossing stop events;
12. the hypersensitive problem (LGL7, tf = 10000, MeshTol 1e-6) through
   `phase.solve_optimize()` with the adaptive mesh on: every re-solve
   factors another K;
13. the adaptive-mesh Delta III (40 segments a phase to start, "deboor",
   MeshTol 1e-7) through `ocp.solve_optimize()`, against the JAX package
   and the published optimum;
14. the three mesh-error estimators on the solved Delta III of phase 10
   (10,004 nodes; "integrator" is one batched propagation of 2500
   segments a phase), and an auto-scaled CartPole at 10,001 nodes with
   unit 1 on every variable against the unscaled solve of phase 6;
15. the default solve (the fused PSIOPT loop with the least-squares
   multiplier start) on the Brachistochrone, the CartPole at 40 and 5000
   segments and formation flying at 256 segments a phase (two linked
   phases, the wide K1 kernel under the fused loop), against the JAX
   package's default solve; `PSIOPT.init`
   and ReturnBest against the JAX package; time-to-solution, host reads
   and factorizations per iteration, peak memory and the stage times;
16. scenario ensembles through `parallel.solve_ensemble`: the
   MultiSpacecraft rendezvous leg of `examples/MultiSpacecraftOptimization.py`
   at 512 scenarios and the CartPole at 10,001 nodes at 16 scenarios,
   each K1 launch covering every lane of a reduction level; lane 0 and the
   lane with the most iterations solved alone must equal their lanes.

Phases 5 to 14 hold the port to the JAX package's host loop, so their
problems run the port's host loop too (`UseFused = False`); phases 15 and
16 run the default, fused, loop.  Every phase resets the K1 launch counts
just before it drives its problem and reads them just after.  The line
before the last two is a JSON object describing every kernel of the main
path (narrow K1 launches from phase 10, wide K1 launches from the
256-segment run of phase 8, and under `launches_elsewhere` those of the
solves of phases 12 to 16); then the card's name and power limit; the
last line is the JSON device record.
"""

import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

OBJ_40 = 58.81031764081469       # JAX package, CPU host loop, 40 segments
OBJ_5000 = 58.80766768910606     # JAX package, CPU host loop, 5000 segments

# The JAX package's CPU host loop (x64, UseFused=False) on the single-phase
# breadth problems: (flag, iterations, objective)
BRACH_24 = {"LGL3": (0, 12, 1.8012955176398973),
            "LGL5": (0, 11, 1.8012954691248915),
            "LGL7": (0, 11, 1.8012954818675209),
            "Trapezoidal": (0, 12, 1.801672045694481),
            "CentralShooting": (0, 12, 1.8012954817635052)}
CARTPOLE_128 = {"BlockConstant": (0, 11, 58.85687489351558),
                "HighestOrderSpline": (0, 12, 58.807699727465184)}
# formation flying (PathToPath link), per-phase segments ->
# (flag, iterations, objective, border width b)
FORMATION = {8: (0, 3, 3.08847184948195, 13),
             80: (0, 3, 3.0009299750648717, 85),
             256: (0, 3, 3.000091316839824, 261),
             512: (0, 3, 3.000022859525826, 517)}
# Delta III, LGL3 segments per phase -> (flag, iterations of
# solve_optimize, final mass in kg)
DELTA3 = {40: (0, 40, 7529.748664196064),
          2500: (0, 53, 7528.398909956162)}
# the adaptive-mesh Delta III of `tests/test_delta3.py` (40 segments a
# phase to start, "deboor", MeshTol 1e-7): (flag, final segments per
# phase, final mass in kg).  The first estimate is already under the
# tolerance in every phase, so no phase is refined.
DELTA3_ADAPTIVE = (0, [40, 40, 40, 40], 7529.748664196064)
DELTA3_PUBLISHED = 7529.749892668763
# the hypersensitive problem of `tests/test_adaptivemesh.py`: (flag,
# segments at each mesh estimate, objective)
HYPERSENS = (0, [10, 59, 380, 1414], 1.6732960912289117)

# The JAX package's numbers below come from `tools/port_references.py`
# (`--all` for the 5000-segment CartPole and the 512 scenarios).
# The JAX package's default solve (the fused loop with the least-squares
# multiplier start; x64, CPU): (flag, iterations, objective)
FUSED = {"Brachistochrone LGL3 24": (0, 8, 1.8012955182586587),
         "CartPole LGL5 40": (0, 10, 58.810317640814674),
         "CartPole LGL5 5000": (0, 14, 58.80766768903671),
         "formation 256": (0, 3, 3.000091316839824)}
# The JAX package's PSIOPT.init on the 40-segment CartPole with a control
# guess of 1 (with the benchmark's guess of 0 the objective gradient, and
# with it every least-squares multiplier, is 0): (|lamE|, lamE[:4], the
# index of the largest |lamE|)
INIT_40 = (25.02271521012259, [0.8609886057067565, -3.231524962787345,
                               -1.3036428454937703, 0.09358654298006391], 361)
# ReturnBest on the 24-segment LGL3 Brachistochrone capped at 4
# iterations: (flag, iterations, objective of the best iterate)
RETURN_BEST = (2, 4, 1.7648249876336402)
# The MultiSpacecraft leg: the baseline default solve (flag, iterations,
# objective), and the JAX package's solve_ensemble of 512 scenarios about
# it (every lane: flag 0 in 3 iterations; the objectives of lanes 0-3)
MSC_BASE = (0, 5, 0.5942206860287187)
MSC_512 = (0, 3, [0.594220686011265, 0.5942206860088641,
                  0.5942206860060142, 0.5942206860108289])


def cartpole_ode(ast):
    """The CartPole ODE of the repository's benchmark, built with either
    package's namespace (`asset_asrl_torch` or `asset_asrl_tpu`)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class CartPole(oc.ODEBase):
        def __init__(self, l, m1, m2, g):
            XtU = oc.ODEArguments(4, 1)
            x, th, xd, thd = XtU.XVec().tolist()
            F = XtU.UVar(0)
            Q = vf.stack([-g * vf.sin(th),
                          F + m2 * l * vf.sin(th) * thd ** 2])
            M = vf.RowMatrix(vf.stack(vf.cos(th), l, m1 + m2,
                                      m2 * l * vf.cos(th)), 2, 2)
            super().__init__(vf.stack([xd, thd, M.inverse() * Q]), 4, 1)

    m1, m2, l, g = 1, .3, .5, 9.81
    return CartPole(l, m1, m2, g)


def build_cartpole(ast, nsegs, tmode="LGL5", cmode=None, u0=.0):
    """The CartPole swing-up phase of the repository's benchmark (LGL5,
    default control mode unless `cmode` is given; `u0` is the control of
    the initial guess), built with either package's namespace."""
    vf = ast.VectorFunctions
    tf, xf = 2.0, 1.0
    ts = np.linspace(0, tf, 100)
    IG = [[xf * t / tf, np.pi * t / tf, 0, 0, t, u0] for t in ts]
    phase = cartpole_ode(ast).phase(tmode, IG, nsegs)
    if cmode is not None:
        phase.setControlMode(cmode)
    phase.addBoundaryValue("First", range(0, 5), [0, 0, 0, 0, 0])
    phase.addBoundaryValue("Last", range(0, 5), [xf, np.pi, 0, 0, tf])
    phase.addLUVarBound("Path", 5, -20.0, 20.0)
    phase.addLUVarBound("Path", 0, -2.0, 2.0)
    phase.addIntegralObjective(vf.Arguments(1)[0] ** 2, [5])
    return phase


def build_brachistochrone(ast, tmode, nsegs=24):
    """The Brachistochrone of `tests/test_fullproblems.py`, built with
    either package's namespace."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    g = 9.81

    class Brachistochrone(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(3, 1)
            x, y, v = XtU.XVec().tolist()
            theta = XtU.UVar(0)
            super().__init__(vf.stack([vf.sin(theta) * v,
                                       -1.0 * vf.cos(theta) * v,
                                       g * vf.cos(theta)]), 3, 1)

    x0, y0, v0, theta0, xf, yf, tf = 0, 10, 0, 1.0, 10, 5, 1
    ts = np.linspace(0, tf, 100)
    IG = [[x0 + (xf - x0) * t / tf, y0 + (yf - y0) * t / tf,
           g * t * np.cos(theta0), t, theta0] for t in ts]
    phase = Brachistochrone().phase(tmode, IG, nsegs)
    phase.addBoundaryValue("Front", range(0, 4), [x0, y0, v0, 0])
    phase.addLUVarBound("Path", 4, -0.1, 2.00)
    phase.addBoundaryValue("Back", [0, 1], [xf, yf])
    phase.addDeltaTimeObjective(1.0)
    return phase


def build_formation(ast, nsegs):
    """Formation flying of `tests/test_pathtopath.py`: two double
    integrators, phase B held at a fixed offset from phase A at every
    node by a PathToPath link.  Returns (ocp, phase A, phase B)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments

    class DoubleIntegrator(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    def phase(x0, xf):
        ts = np.linspace(0, 2, 20)
        IG = [[x0 + (xf - x0) * t / 2, (xf - x0) / 2, t, 0.0] for t in ts]
        ph = DoubleIntegrator().phase("LGL3", IG, nsegs)
        ph.addBoundaryValue("Front", [0, 1, 2], [x0, 0, 0])
        ph.addBoundaryValue("Back", [0, 1, 2], [xf, 0, 2])
        ph.addIntegralObjective(Args(1)[0] ** 2, [3])
        return ph

    pa, pb = phase(0.0, 1.0), phase(0.2, 1.2)
    ocp = oc.OptimalControlProblem()
    ocp.addPhase(pa)
    ocp.addPhase(pb)
    A = Args(2)
    ocp.addDirectLinkEqualCon(A[0] - A[1] + 0.2, pa, "Path", [0],
                              pb, "Path", [0])
    return ocp, pa, pb


# Delta III launch (`tests/test_delta3.py`), canonical units
D3 = dict(Lstar=6378145, Tstar=961.0, Mstar=301454.0)


def build_delta3(ast, nsegs, adaptive=False):
    """The 4-phase Delta III launch of `tests/test_delta3.py` on a mesh of
    `nsegs` LGL3 segments per phase, with the test's L1 line searches and
    MaxLSIters 2, built with either package's namespace.  The mesh is
    fixed, or with `adaptive` refined as in that test ("deboor" estimator,
    MeshTol 1e-7, at most 4 mesh iterations).  Returns (ocp, phases)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments
    Lstar, Tstar, Mstar = D3["Lstar"], D3["Tstar"], D3["Mstar"]
    g0 = 9.80665
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
    CD, S = .5, 4 * np.pi / Lstar ** 2
    TS, T1, T2 = 628500 / Fstar, 1083100 / Fstar, 110094 / Fstar
    IS, I1, I2 = 283.33364 / Tstar, 301.68 / Tstar, 467.21 / Tstar
    tS, t1, t2 = 75.2 / Tstar, 261 / Tstar, 700 / Tstar
    TMS, TM1, TM2, TMPay = (19290 / Mstar, 104380 / Mstar, 19300 / Mstar,
                            4164 / Mstar)
    PMS, PM1, PM2 = 17010 / Mstar, 95550 / Mstar, 16820 / Mstar
    SMS, SM1 = TMS - PMS, TM1 - PM1
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
            Vdot = (-mu) * R.normalized_power3() + (T * u + D) / m
            super().__init__(vf.stack(V, Vdot, -mdot), 7, 3)

    def target_orbit(at, et, it, Ot, Wt):
        R, V = Args(6).tolist([(0, 3), (3, 3)])
        r, v = R.norm(), V.norm()
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

    at, et = 24361140 / Lstar, .7308
    Ot, Wt = np.deg2rad(269.8), np.deg2rad(130.5)
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

    phases = []
    for i in range(4):
        p = RocketODE(T_phase[i], mdot_phase[i]).phase("LGL3", IGs[i],
                                                        nsegs)
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
    phases[3].addEqualCon("Back", target_orbit(at, et, istart, Ot, Wt),
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
    if adaptive:
        ocp.setAdaptiveMesh(True)
        for p in phases:
            p.MeshTol = 1e-7
            p.MaxMeshIters = 4
            p.MeshErrorEstimator = "deboor"
    return ocp, phases


def two_body_ode(ast):
    """The two-body problem (mu = 1), rows [r, v, t]."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class TwoBody(oc.ODEBase):
        def __init__(self):
            a = oc.ODEArguments(6, 0)
            R, V = a.XVec().head3(), a.XVec().tail3()
            super().__init__(vf.stack(V, -1.0 * R.normalized_power3()), 6)
    return TwoBody()


def two_body_rows(n, seed=11):
    """Seeded bound two-body rows [r, v, t0 = 0] (eccentricity up to about
    0.3, any inclination) and the period of each."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 7))
    r = 1.0 + 0.2 * rng.uniform(-1, 1, n)
    rows[:, 0] = r
    speed = np.sqrt(1.0 / r) * (1.0 + 0.15 * rng.uniform(-1, 1, n))
    ang = rng.uniform(0, 2 * np.pi, n)
    fpa = 0.2 * rng.uniform(-1, 1, n)
    rows[:, 3] = speed * np.sin(fpa)
    rows[:, 4] = speed * np.cos(fpa) * np.cos(ang)
    rows[:, 5] = speed * np.cos(fpa) * np.sin(ang)
    a = 1.0 / (2.0 / r - speed ** 2)
    return rows, 2 * np.pi * a ** 1.5


def build_hypersens(ast):
    """The hypersensitive problem of `tests/test_adaptivemesh.py`: LGL7,
    10 segments to start, tf = 10000, adaptive mesh with MeshTol 1e-6 and
    the default "integrator" estimator."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class HyperSens(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(1, 1)
            super().__init__(-XtU.XVar(0) + XtU.UVar(0), 1, 1)

    xt0, xtf, tf = 1.5, 1.0, 10000.0
    IG = [[xt0 * (1 - t / tf) + xtf * (t / tf), t, 0]
          for t in np.linspace(0, tf, 1000)]
    phase = HyperSens().phase("LGL7", IG, 10)
    phase.addBoundaryValue("First", [0, 1], [xt0, 0])
    phase.addBoundaryValue("Last", [0, 1], [xtf, tf])
    phase.addIntegralObjective(vf.Arguments(2).squared_norm() / 2, [0, 2])
    phase.addLUVarBound("Path", 0, -50, 50)
    phase.addLUVarBound("Path", 2, -50, 50)
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_SoeLSMode("L1")
    phase.setAdaptiveMesh(True)
    phase.setMeshTol(1.0e-6)
    phase.setMaxMeshIters(8)
    return phase


def build_multispacecraft(ast, nsegs=12):
    """The low-thrust rendezvous leg of the MultiSpacecraft ensemble
    (`examples/MultiSpacecraftOptimization.py`, `ensemble_demo`): a
    two-body phase with a 3-component thrust acceleration, LGL3 on 12
    segments (10 variables a node), from a circular orbit to a target 4
    degrees ahead of the half-revolution point, minimizing the integral of
    the squared thrust; built with either package's namespace."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    Args = vf.Arguments

    class TwoBody(oc.ODEBase):
        def __init__(self, ltacc=0.0):
            args = oc.ODEArguments(6, 3 if ltacc else 0)
            r, v = args.head3(), args.segment3(3)
            acc = r.normalized_power3() * (-1.0)
            if ltacc:
                acc = acc + args.tail3() * ltacc
            super().__init__(vf.stack([v, acc]), 6, 3 if ltacc else 0)

    def circ(r, thetadeg):
        v, th = np.sqrt(1.0 / r), np.deg2rad(thetadeg)
        return np.array([np.cos(th) * r, np.sin(th) * r, 0.0,
                         -np.sin(th) * v, np.cos(th) * v, 0.0, 0.0])

    rows = TwoBody().integrator(.01).integrate_dense(circ(1, 0.0), np.pi, 40)
    IG = [np.concatenate([np.asarray(row)[:7], [0.01, 0, 0]]) for row in rows]
    target = circ(1.0, np.rad2deg(np.pi) + 4.0)
    phase = TwoBody(ltacc=0.05).phase("LGL3", IG, nsegs)
    phase.addBoundaryValue("Front", range(0, 7), np.asarray(IG[0][:7]))
    phase.addUpperNormBound("Path", [7, 8, 9], 1.0)
    phase.addBoundaryValue("Back", [6], [np.pi])
    phase.addEqualCon("Back", Args(6) - target[0:6], range(0, 6))
    phase.addIntegralObjective(Args(3).squared_norm(), [7, 8, 9])
    return phase


def quasi_definite_blocks(K, W, seed, dtype):
    """Seeded symmetric quasi-definite blocks: a positive definite
    leading half and a negative definite trailing half, as the
    regularized KKT macro-blocks are."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, W, W))
    A = (A + A.transpose(0, 2, 1)) / 2
    h = (W + 1) // 2
    A[:, :h, :h] += W * np.eye(h)
    A[:, h:, h:] -= W * np.eye(W - h)
    return torch.tensor(A, dtype=dtype, device="cuda")


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls=10, reps=20):
    """Device time of one fn(): `calls` calls captured into a CUDA graph,
    median of `reps` CUDA-event timings of a replay, over `calls`.  The
    replay has no host work between launches, so a kernel that is shorter
    than its wrapper's host time is still timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps) / calls


# H100 SXM data sheet: device memory rate, and the card's peak rates for
# the type: FP64 through the tensor cores (mma.sync DMMA; K1's plain FMAs
# can reach half of it), FP32 outside them
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}


def k1_bound(K, W, dtype):
    """Least time (ms) the card could take for K1 on a (K, W, W) batch: the
    larger of the bytes moved once (block in, inverse and pivots and
    counts out) over the memory rate and 2 W^3 operations a block over the
    peak rate.  Returns (bound_ms, "bytes" or "operations")."""
    size = torch.finfo(dtype).bits // 8
    t_bytes = (K * W * (2 * W + 1) * size + 4 * K) / PEAK_BYTES
    t_ops = 2.0 * K * W ** 3 / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def plain_inertia(ck, D):
    """The plain count of bad pivots and the zeroed inverse, from the
    unblocked plain elimination on D's device."""
    X, p = ck.gj_inverse_ref(D)
    tiny = 1e-25 if D.dtype == torch.float32 else 1e-250
    nbad = ((p < 0) | ~torch.isfinite(p) | (p.abs() < tiny)).sum(1)
    return torch.where(torch.isfinite(X), X, torch.zeros_like(X)), p, nbad


# (K, W) at which K1 is held against its plain versions, and the f64
# shapes at which it is timed: the BCR levels of the 10^4-node problems
# (W 24 and 25), the other widths of the solves below, both ends of each
# kernel's range, and the borders of 80 to 1024 segments a phase
K1_SHAPES = [(2500, 24), (1250, 24), (156, 24), (1, 24), (5002, 25),
             (2501, 25), (1, 1), (1, 2), (514, 8), (25, 11), (13, 27), (3, 32), (3, 33),
             (65, 42), (3, 64), (1, 65), (1, 85), (1, 160), (1, 255),
             (1, 261), (2, 511), (1, 517), (1, 1029), (40000, 24),
             (3072, 22), (512, 3)]
# the last three: the first reduction level of the 16-lane CartPole
# ensemble (16 x 2500 blocks), the first level and the border of the
# 512-lane MultiSpacecraft ensemble (512 x 6 blocks, 512 borders)
K1_TIMED = [(2500, 24), (156, 24), (1, 24), (5002, 25), (2501, 25),
            (514, 8), (25, 11), (1, 255), (1, 261), (1, 517), (1, 1029),
            (40000, 24), (3072, 22), (512, 3)]
# the shape of each kernel's entry in the kernels line, and the run that
# its launches are read from: the first reduction level of Delta III at
# 10,004 nodes, the border of formation flying at 256 segments
K1_MAIN = {(5002, 25): ("gj_inverse", "Delta III, 10,004 nodes"),
           (1, 261): ("gj_inverse_wide", "formation flying, 256 segments")}


def phase_kernel(ck):
    """Phase 3: K1 (narrow kernels up to W = 64, the blocked wide kernel
    above) against its plain versions, f64 and f32.  Tolerances: 1e-12
    (f64) and 1e-4 (f32) relative on the inverse and on the pivots, and
    equal pivot signs; the wide kernel's pivots are sums taken in another
    order than the unblocked plain version's, so they are equal to
    rounding, not bitwise.  Returns the f64 measurements by (K, W)."""
    out = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for i, (K, W) in enumerate(K1_SHAPES):
            D = quasi_definite_blocks(K, W, seed=100 + i, dtype=dtype)
            n0, w0 = ck.gj_inverse.launches, ck.gj_inverse.wide_launches
            X, p = ck.gj_inverse(D)
            wide = W > ck.MAX_W
            check((ck.gj_inverse.wide_launches - w0,
                   ck.gj_inverse.launches - n0) == ((1, 0) if wide
                                                    else (0, 1)),
                  f"K1 at width {W} did not launch the expected kernel")
            Xi, pi, nbad = ck.gj_inverse_inertia(D)
            X2, p2, nbad2 = ck.gj_inverse_inertia(D)
            torch.cuda.synchronize()
            Xr, pr, nbad_r = plain_inertia(ck, D)
            ex, ep = rel(X, Xr), rel(p, pr)
            signs = bool(torch.equal(torch.sign(p), torch.sign(pr)))
            same = all(torch.equal(a, b) for a, b in
                       ((X, Xi), (p, pi), (Xi, X2), (pi, p2), (nbad, nbad2)))
            note = ""
            if wide:
                Xb, pb = ck.gj_inverse_blocked_ref(D)
                eb = max(rel(X, Xb), rel(p, pb))
                note = f"  blocked plain rel {eb:.3e}"
                check(eb <= tol, f"wide K1 disagrees with the blocked plain "
                      f"version at ({K},{W}) {dtype}")
            print(f"K1{' wide' if wide else ''} {str(dtype)[6:]} "
                  f"({K},{W},{W}): inverse rel {ex:.3e}  pivots rel "
                  f"{ep:.3e}{note}  signs equal {signs}  bad pivots "
                  f"{int(nbad.sum())} (plain {int(nbad_r.sum())})  second "
                  f"run bitwise equal {same}")
            check(ex <= tol and ep <= tol and signs,
                  f"K1 disagrees with its plain version at ({K},{W}) "
                  f"{dtype}")
            check(torch.equal(nbad.long(), nbad_r),
                  f"K1 bad-pivot count off at ({K},{W}) {dtype}")
            check(same, f"K1 not bitwise repeatable at ({K},{W}) {dtype}")
            if dtype == torch.float64 and (K, W) in K1_TIMED:
                bound, by = k1_bound(K, W, dtype)
                m = out[(K, W)] = dict(
                    max_abs_err=float((X - Xr).abs().max()),
                    ms=graph_ms(lambda: ck.gj_inverse_inertia(D)),
                    call_ms=cuda_ms(lambda: ck.gj_inverse_inertia(D)),
                    plain_ms=cuda_ms(lambda: ck.gj_inverse_ref(D), reps=5),
                    bound_ms=bound, bound_by=by,
                    library_ms=cuda_ms(lambda: torch.linalg.inv_ex(D)))
                print(f"  timing ({K},{W},{W}) f64: kernel {m['ms']:.5f} ms "
                      f"on the device (graph replay), {m['call_ms']:.5f} ms "
                      f"a wrapper call; bound {bound:.6f} ms by {by} "
                      f"({100 * bound / m['ms']:.2f}% of the kernel's time); plain "
                      f"{m['plain_ms']:.4f} ms; torch.linalg.inv_ex "
                      f"{m['library_ms']:.4f} ms")

        # a block with a zero pivot and a NaN pivot among clean ones
        for W in (24, 40, 70, 261):
            D = quasi_definite_blocks(3, W, seed=7, dtype=dtype)
            zero, nan = W // 3, W // 2
            D[1, [zero, nan], :] = 0.0
            D[1, :, [zero, nan]] = 0.0
            D[1, nan, nan] = float("nan")
            X, p, nbad = ck.gj_inverse_inertia(D)
            torch.cuda.synchronize()
            Xr, pr, nbad_r = plain_inertia(ck, D)
            print(f"K1 {str(dtype)[6:]} (3,{W},{W}) with a zero and a NaN "
                  f"pivot: bad pivots {nbad.tolist()} (plain "
                  f"{nbad_r.tolist()}), inverse rel {rel(X, Xr):.3e}")
            check(torch.equal(nbad.long(), nbad_r)
                  and float(p[1, zero]) == 0.0
                  and bool(torch.isnan(p[1, nan]))
                  and bool(torch.isfinite(X).all()) and rel(X, Xr) <= tol,
                  f"K1 inertia epilogue off at width {W} {dtype}")
    return out


def print_ptxas(ck):
    """What ptxas -v reported for the built kernels: the totals, and the
    lines of the instances the solves below launch most."""
    want = ("Li8E", "Li12E", "Li24E", "Li28E", "Li44E", "Li64E", "panel",
            "update")
    for log in ck.build.logs:
        with open(log) as f:
            txt = f.read()
        names = re.findall(r"Compiling entry function '(\S+)'", txt)
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", txt)]
        spill = [tuple(map(int, m)) for m in re.findall(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) "
            r"bytes spill loads", txt)]
        print(f"ptxas {log.rsplit('/', 1)[-1]}: {len(names)} kernels, "
              f"registers up to {max(regs)}, stack frame up to "
              f"{max(s[0] for s in spill)} B, spill stores up to "
              f"{max(s[1] for s in spill)} B")
        for n, r, sp in zip(names, regs, spill):
            if any(w in n for w in want):
                print(f"  {n}: {r} registers, stack/spill stores/loads {sp}")


def phase_bcr(kb):
    """Phase 4: bcr_factor/bcr_solve at (K=64, W=24, b=2)."""
    K, W, b = 64, 24, 2
    for seed, spd in ((0, True), (1, False), (2, False)):
        rng = np.random.default_rng(seed)
        diag = rng.normal(size=(K, W, W))
        diag = (diag + diag.transpose(0, 2, 1)) / 2
        if spd:
            diag += W * np.eye(W)
        lower = rng.normal(size=(K, W, W)) * 0.3
        lower[-1] = 0.0
        B = rng.normal(size=(K, W, b)) * 0.2
        C = rng.normal(size=(b, b))
        C = (C + C.T) / 2 - b * np.eye(b)
        A = np.zeros((K * W + b, K * W + b))
        for k in range(K):
            A[k * W:(k + 1) * W, k * W:(k + 1) * W] = diag[k]
            if k + 1 < K:
                A[(k + 1) * W:(k + 2) * W, k * W:(k + 1) * W] = lower[k]
                A[k * W:(k + 1) * W, (k + 1) * W:(k + 2) * W] = lower[k].T
            A[k * W:(k + 1) * W, K * W:] = B[k]
            A[K * W:, k * W:(k + 1) * W] = B[k].T
        A[K * W:, K * W:] = C
        t = [torch.tensor(a, dtype=torch.float64, device="cuda")
             for a in (diag, lower, B, C, A)]
        fac, neigs = kb.bcr_factor(*(a[None] for a in t[:4]))
        neigs = neigs[0]
        At = t[4]
        r = torch.tensor(rng.normal(size=(K, W)), dtype=torch.float64,
                         device="cuda")
        rb = torch.tensor(rng.normal(size=(b,)), dtype=torch.float64,
                          device="cuda")
        y, z = (a[0] for a in kb.bcr_solve(fac, r[None], rb[None]))
        ref = torch.linalg.solve(At, torch.cat([r.reshape(-1), rb]))
        err = rel(torch.cat([y.reshape(-1), z]), ref)
        nneg = int((torch.linalg.eigvalsh(At) < 0).sum())
        print(f"BCR (64,24,2) seed {seed}: solve rel {err:.3e}, inertia "
              f"{int(neigs)} vs eigvalsh {nneg}")
        check(err < 1e-8, "BCR solve disagrees with the dense solve")
        check(int(neigs) == nneg, "BCR inertia disagrees with eigvalsh")


def reset_peak_memory():
    """Start a peak-memory reading: the problems of earlier phases are
    collected first, so that the peak is this problem's alone."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def run_phase(ast, ck, nsegs):
    ph = build_cartpole(ast, nsegs)
    ph.optimizer.set_PrintLevel(1)
    ph.optimizer.UseFused = False       # held to the JAX host loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ph.transcribe()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ck.gj_inverse.launches = 0
    flag = ph.optimize()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ck.gj_inverse.launches
    traj = np.asarray(ph.returnTraj())
    check(traj.shape == (ph.numNodes, 6) and np.isfinite(traj).all(),
          "trajectory is not finite or has the wrong shape")
    return ph, flag, launches, t1 - t0, t2 - t1


def phase_slice40(ast, ck):
    """Phase 5: 40 segments against the JAX package's CPU result, and a
    bitwise repeatability check of the factorization."""
    ph, flag, launches, _, _ = run_phase(ast, ck, 40)
    opt = ph.optimizer
    it, obj = opt.LastIterNum, opt.LastObjVal
    print(f"slice 40 segs: flag {flag} iters {it} obj {obj:.15f} "
          f"K1 launches {launches}")
    check(flag == 0, "40-segment solve did not converge")
    check(abs(it - 10) <= 1, "40-segment iteration count off")
    check(abs(obj - OBJ_40) <= 1e-7 * OBJ_40, "40-segment objective off")
    check(launches > 0, "40-segment solve never launched K1")

    check_repeatable_factor(opt, ph.makeSolverInput())


def check_repeatable_factor(opt, x):
    """Factor the final iterate twice: the two factors must be bitwise
    equal (gather-table assembly, no atomics)."""
    kkt = opt.kkt
    x = torch.tensor(x, dtype=torch.float64, device="cuda")
    lamE, lamI, s = (torch.tensor(a, dtype=torch.float64, device="cuda")
                     for a in (opt.LastEqLmults, opt.LastIqLmults,
                               opt.LastSlacks))
    sig_tilde = lamI / s.clamp_min(1e-12)
    facs = [kkt.factor(x, lamE, lamI, 1.0, sig_tilde, 0.0, opt.gammaE)
            for _ in range(2)]

    def flat(f):
        out = [f["D0inv"], f["B0"], f["Cinv"]] + list(f["iq_jx"])
        for lev in f["levels"]:
            out += [lev["Dinv"], lev["L_le"], lev["L_er"], lev["B_odd"]]
        return out
    same = facs[0][1] == facs[1][1] and all(
        torch.equal(a, b) for a, b in zip(flat(facs[0][0]), flat(facs[1][0])))
    print(f"factor of one iterate twice: bitwise equal {same}")
    check(same, "factorization is not bitwise repeatable")


def phase_slice5000(ast, ck):
    """Phase 6: the 10,001-node problem."""
    reset_peak_memory()
    ph, flag, launches, t_setup, t_solve = run_phase(ast, ck, 5000)
    opt = ph.optimizer
    it, obj = opt.LastIterNum, opt.LastObjVal
    peak = torch.cuda.max_memory_allocated()
    bs = opt.kkt.bs
    print(f"slice 5000 segs ({ph.numNodes} nodes, K {bs.K} W {bs.W} "
          f"b {bs.b}): flag {flag} iters {it} obj {obj:.15f}")
    print(f"  transcription {t_setup:.3f} s, optimize (time-to-solution) "
          f"{t_solve:.3f} s, {it / t_solve:.3f} iterations/s, peak device "
          f"memory {peak / 2**20:.1f} MiB, K1 launches {launches}")
    print(f"  host-clock split of optimize: function evaluation "
          f"{opt.LastFuncTime:.3f} s, KKT factor+solve {opt.LastKKTTime:.3f} s")
    check(flag == 0, "10,001-node solve did not converge")
    check(abs(obj - OBJ_5000) <= 1e-6 * OBJ_5000,
          "10,001-node objective off")
    check(launches > 0, "10,001-node solve never launched K1")
    return obj


def counted(ck, fn):
    """Run fn() with the K1 launch counts set to 0 just before it; returns
    (fn's result, narrow launches, wide launches, seconds)."""
    torch.cuda.synchronize()
    ck.gj_inverse.launches = 0
    ck.gj_inverse.wide_launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, ck.gj_inverse.launches, ck.gj_inverse.wide_launches,
            time.perf_counter() - t0)


def phase_breadth(ast, ck):
    """Phase 7: single-phase breadth, every transcription and the
    BlockConstant / HighestOrderSpline control modes."""
    cases = [("Brachistochrone", tm, build_brachistochrone(ast, tm, 24), ref)
             for tm, ref in BRACH_24.items()]
    cases += [("CartPole LGL5 128", cm, build_cartpole(ast, 128, "LGL5", cm),
               ref) for cm, ref in CARTPOLE_128.items()]
    for prob, mode, ph, (rflag, rit, robj) in cases:
        ph.optimizer.set_PrintLevel(2)
        ph.optimizer.UseFused = False   # held to the JAX host loop
        flag, n1, _, secs = counted(ck, ph.optimize)
        it, obj = ph.optimizer.LastIterNum, ph.optimizer.LastObjVal
        bs = ph.optimizer.kkt.bs
        print(f"{prob} {mode}: flag {flag} iters {it} obj {obj:.15f} "
              f"(K {bs.K} W {bs.W} b {bs.b}) K1 launches {n1}, "
              f"{secs:.3f} s")
        check(flag == rflag, f"{prob} {mode}: flag {flag}")
        check(abs(it - rit) <= 1, f"{prob} {mode}: iterations {it}")
        check(abs(obj - robj) <= 1e-7 * abs(robj),
              f"{prob} {mode}: objective {obj}")
        check(n1 > 0, f"{prob} {mode}: K1 never launched")
        traj = np.asarray(ph.returnTraj())
        check(np.isfinite(traj).all(), f"{prob} {mode}: trajectory")


def phase_formation(ast, ck, nsegs):
    """Phase 8: formation flying with a PathToPath link; the border
    (b = segments + 5) is wider than 64, so it goes through the wide K1
    kernel.  Returns the wide kernel's launches."""
    rflag, rit, robj, rb = FORMATION[nsegs]
    ocp, pa, pb = build_formation(ast, nsegs)
    ocp.optimizer.set_PrintLevel(2)
    ocp.optimizer.UseFused = False      # held to the JAX host loop
    flag, n1, nw, secs = counted(ck, ocp.optimize)
    it, obj = ocp.optimizer.LastIterNum, ocp.optimizer.LastObjVal
    bs = ocp.optimizer.kkt.bs
    print(f"formation flying {nsegs} segs (K {bs.K} W {bs.W} b {bs.b}): "
          f"flag {flag} iters {it} obj {obj:.16f}, K1 launches {n1} "
          f"narrow / {nw} wide, {secs:.3f} s")
    check(flag == rflag and it == rit, "formation flying flag/iterations")
    check(abs(obj - robj) <= 1e-8 * robj, "formation flying objective")
    check(bs.b == rb, f"formation flying border {bs.b} != {rb}")
    check(nw > 0, "formation flying never launched the wide K1 kernel")
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    check(np.abs(gap - 0.2).max() < 1e-6, "formation offset not held")
    return nw


def run_delta3(ast, ck, nsegs):
    ocp, phases = build_delta3(ast, nsegs)
    ocp.optimizer.set_PrintLevel(1)
    ocp.optimizer.UseFused = False      # held to the JAX host loop
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ocp.transcribe()
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    flag, n1, nw, t_solve = counted(ck, ocp.solve_optimize)
    opt = ocp.optimizer
    mass = phases[3].returnTraj()[-1][6] * D3["Mstar"]
    bs = opt.kkt.bs
    nodes = sum(p.numNodes for p in phases)
    print(f"Delta III {nsegs} segs/phase ({nodes} nodes, K {bs.K} W {bs.W} "
          f"b {bs.b}): flag {flag} iters {opt.LastIterNum} final mass "
          f"{mass:.12f} kg, K1 launches {n1} narrow / {nw} wide")
    rflag, rit, rmass = DELTA3[nsegs]
    check(flag == rflag, f"Delta III {nsegs}: flag {flag}")
    check(abs(opt.LastIterNum - rit) <= 1,
          f"Delta III {nsegs}: iterations {opt.LastIterNum}")
    check(n1 > 0, f"Delta III {nsegs}: K1 never launched")
    for p in phases:
        check(np.isfinite(np.asarray(p.returnTraj())).all(),
              f"Delta III {nsegs}: trajectory not finite")
    return ocp, mass, n1, t_setup, t_solve


def phase_delta3_40(ast, ck):
    """Phase 9: Delta III at 40 segments per phase, and a bitwise
    repeatability check of one factorization."""
    ocp, mass, _, _, _ = run_delta3(ast, ck, 40)
    rmass = DELTA3[40][2]
    check(abs(mass - rmass) <= 1e-7 * rmass, "Delta III 40: final mass")
    check_repeatable_factor(ocp.optimizer, ocp._make_input())


def phase_delta3_full(ast, ck):
    """Phase 10: Delta III at 2500 segments per phase (10,004 nodes)."""
    reset_peak_memory()
    ocp, mass, launches, t_setup, t_solve = run_delta3(ast, ck, 2500)
    opt = ocp.optimizer
    it = opt.LastIterNum
    peak = torch.cuda.max_memory_allocated()
    print(f"  transcription {t_setup:.3f} s, solve_optimize "
          f"(time-to-solution) {t_solve:.3f} s, {it / t_solve:.3f} "
          f"iterations/s, peak device memory {peak / 2**20:.1f} MiB, "
          f"K1 launches {launches}")
    print(f"  host-clock split of solve_optimize: function evaluation "
          f"{opt.LastFuncTime:.3f} s, KKT factor+solve {opt.LastKKTTime:.3f} s")
    rmass = DELTA3[2500][2]
    check(abs(mass - rmass) <= 1e-6 * rmass, "Delta III 2500: final mass")
    return launches, ocp.Phases


# the JAX package's CPU result (DOPRI87, default step 0.1, AbsTol 1e-12) for
# the first 4 rows of two_body_rows(4096), each over its own period
TWO_BODY_JAX = np.array([
    [8.5142808110691826e-01, 1.9683262318463770e-12, 8.8398449876160289e-13,
     -4.1582191589047079e-02, 8.7888174656081530e-01, 3.9471144794300128e-01,
     3.7169786330663501e+00],
    [9.9971114497499658e-01, -4.3221075958526306e-12,
     -1.3764257348266924e-12, 4.0496656580893839e-02, 9.9528846259146464e-01,
     3.1696734859561798e-01, 7.2634680456883096e+00],
    [1.0405993430501908e+00, 3.3684183021901267e-13, 1.6426816422977319e-12,
     -1.6194179729347688e-01, 2.0051679106905462e-01, 9.7804063162506161e-01,
     7.3715596992523862e+00],
    [8.1147560334745783e-01, -7.9334022412544955e-14, 2.4311399666574400e-13,
     6.6650112799040748e-02, -3.4934312380000310e-01, 1.0706006624774353e+00,
     4.8281185191634144e+00]])


def phase_integrator(ast):
    """Phase 11: the batched adaptive integrator on the card."""
    nrows, nstm, ncpu = 4096, 256, 16
    rows, periods = two_body_rows(nrows)
    integ = two_body_ode(ast).integrator("DOPRI87", 0.1)
    dev_rows, dev_tfs = integ._rows(rows[:8], periods[:8])
    out, _, _ = integ._advance(dev_rows, dev_tfs)
    check(dev_rows.is_cuda and out.is_cuda,
          "the integrator's tensors are not on the card")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xf = np.stack(integ.integrate_parallel(rows, periods))
    secs = time.perf_counter() - t0
    steps = integ.LastStepCount
    print(f"integrator: {nrows} two-body rows over one period each, "
          f"DOPRI87, AbsTol 1e-12: {secs:.3f} s, {nrows / secs:.1f} rows/s, "
          f"{steps} steps in the longest row")
    check(np.isfinite(xf).all(), "integrated rows are not finite")
    closure = np.abs(xf[:, :6] - rows[:, :6]).max()
    print(f"  orbits close to {closure:.3e} after one period")
    check(closure < 1e-9, "the orbits do not close after one period")
    ej = np.abs(xf[:4] - TWO_BODY_JAX).max()
    print(f"  first 4 rows against the JAX package's CPU run: {ej:.3e}")
    check(ej <= 1e-9, "integrated rows differ from the JAX package's")

    # the same ODE built on the CPU, for the port's own CPU run
    ast.config.use_device("cpu")
    try:
        cpu = two_body_ode(ast).integrator("DOPRI87", 0.1)
        xc = np.stack(cpu.integrate_parallel(rows[:ncpu], periods[:ncpu]))
        sc, Jc = cpu.integrate_stm(rows[0], periods[0])
    finally:
        ast.config.use_device("cuda")
    ec = np.abs(xf[:ncpu] - xc).max()
    print(f"  first {ncpu} rows against the port's CPU run: {ec:.3e}")
    check(ec <= 1e-9, "integrated rows differ between the card and the CPU")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stm = integ.integrate_stm_parallel(rows[:nstm], periods[:nstm])
    secs = time.perf_counter() - t0
    J = np.stack([j for _, j in stm])
    dets = np.linalg.det(J[:, :6, :6])
    eJ = np.abs(J[0] - Jc).max() / np.abs(Jc).max()
    print(f"  state-transition matrices of {nstm} rows: {secs:.3f} s, "
          f"{nstm / secs:.1f} rows/s; |det - 1| up to "
          f"{np.abs(dets - 1).max():.3e}; row 0 against the CPU run "
          f"{eJ:.3e} relative")
    check(np.isfinite(J).all() and J.shape == (nstm, 7, 7),
          "state-transition matrices are not finite")
    check(np.abs(dets - 1).max() < 1e-6,
          "state-transition matrices are not volume preserving")
    check(eJ <= 1e-8, "state-transition matrix differs between the card "
          "and the CPU")

    # events: from apoapsis, stop where r.v rises through zero (periapsis,
    # half a period later)
    nev = 32
    rng = np.random.default_rng(12)
    ra = 1.0 + 0.3 * rng.uniform(0, 1, nev)
    va = np.sqrt(1.0 / ra) * (0.7 + 0.2 * rng.uniform(0, 1, nev))
    ev_rows = np.zeros((nev, 7))
    ev_rows[:, 0], ev_rows[:, 4] = ra, va
    a = 1.0 / (2.0 / ra - va ** 2)
    half = np.pi * a ** 1.5
    A = ast.VectorFunctions.Arguments(7)
    rdotv = A.head3().dot(A.segment3(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = integ.integrate_dense_parallel(ev_rows, 3 * half, [(rdotv, 1, 1)],
                                         nsteps=2)
    secs = time.perf_counter() - t0
    tstop = np.array([traj[-1][6] for traj, _ in res])
    rstop = np.array([traj[-1][0] for traj, _ in res])
    et = np.abs(tstop - half).max()
    print(f"  periapsis-crossing stop events of {nev} rows: {secs:.3f} s, "
          f"stop times off by up to {et:.3e}")
    check(all(len(locs[0]) == 1 for _, locs in res),
          "an orbit did not stop at its first periapsis")
    check(et < 1e-8, "periapsis times are off")
    check(np.abs(rstop + (2 * a - ra)).max() < 1e-7,
          "periapsis positions are off")


@contextlib.contextmanager
def mesh_log():
    """Record (segments, combined error) at every mesh-error estimate of
    the adaptive loops run inside the block."""
    from asset_asrl_torch.OptimalControl import mesh
    seen = []
    plain = mesh.segment_errors

    def spy(phase):
        errs = plain(phase)
        seen.append((phase.numSegs,
                     mesh._combine(errs, phase.MeshErrorCriteria)))
        return errs
    mesh.segment_errors = spy
    try:
        yield seen
    finally:
        mesh.segment_errors = plain


def phase_hypersens(ast, ck):
    """Phase 12: the hypersensitive problem with the adaptive mesh.  The
    objective is held to 5e-5 relative: the last mesh is laid out by error
    estimates that are rounding noise over the flat middle of the
    trajectory, so its bounds, and with them the quadrature value it
    converges to, differ in the sixth digit between two machines (JAX on a
    CPU 1.673296, the port on a CPU 1.673286, on an H100 1.673283)."""
    rflag, rsegs, robj = HYPERSENS
    ph = build_hypersens(ast)
    ph.optimizer.set_PrintLevel(2)
    ph.optimizer.UseFused = False       # held to the JAX host loop
    reset_peak_memory()
    with mesh_log() as seen:
        flag, n1, nw, secs = counted(ck, ph.solve_optimize)
    obj = ph.optimizer.LastObjVal
    for i, (segs, err) in enumerate(seen):
        print(f"hypersensitive mesh iteration {i}: {segs} segments, error "
              f"{err:.3e}")
    print(f"hypersensitive adaptive: flag {flag}, {len(seen)} mesh "
          f"estimates, final segments {ph.numSegs}, obj {obj:.15f}, "
          f"{secs:.3f} s, K1 launches {n1} narrow / {nw} wide, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check(flag == rflag and ph.MeshConverged, "hypersensitive: flag")
    check([s for s, _ in seen] == rsegs,
          f"hypersensitive: segments per mesh iteration {seen}")
    check(abs(obj - robj) <= 5e-5 * robj, f"hypersensitive: objective {obj}")
    check(n1 > 0, "hypersensitive: K1 never launched")
    tab = ph.returnTrajTable()
    check(all(t.is_cuda for t in tab._tensors()),
          "the trajectory table's tensors are not on the card")
    return n1, nw


def phase_delta3_adaptive(ast, ck):
    """Phase 13: the adaptive-mesh Delta III at the width of the upstream
    regression."""
    rflag, rsegs, rmass = DELTA3_ADAPTIVE
    ocp, phases = build_delta3(ast, 40, adaptive=True)
    ocp.optimizer.set_PrintLevel(2)
    ocp.optimizer.UseFused = False      # held to the JAX host loop
    reset_peak_memory()
    with mesh_log() as seen:
        flag, n1, nw, secs = counted(ck, ocp.solve_optimize)
    mass = phases[3].returnTraj()[-1][6] * D3["Mstar"]
    segs = [p.numSegs for p in phases]
    print(f"Delta III adaptive: flag {flag}, {len(seen) // 4} mesh "
          f"iterations (errors {[f'{e:.3e}' for _, e in seen]}), segments "
          f"{segs}, final mass {mass:.12f} kg "
          f"({mass - DELTA3_PUBLISHED:+.6f} kg from the published optimum), "
          f"time-to-solution {secs:.3f} s, K1 launches {n1} narrow / {nw} "
          f"wide, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    check(flag == rflag, f"Delta III adaptive: flag {flag}")
    check(segs == rsegs, f"Delta III adaptive: segments {segs}")
    check(all(p.MeshConverged for p in phases),
          "Delta III adaptive: mesh not converged")
    check(abs(mass - rmass) <= 1e-7 * rmass, "Delta III adaptive: final mass")
    check(abs(mass - DELTA3_PUBLISHED) < 0.01,
          "Delta III adaptive: not within 0.01 kg of the published optimum")
    check(n1 > 0, "Delta III adaptive: K1 never launched")
    return n1, nw


def phase_estimators(ast, ck, phases, obj_unscaled):
    """Phase 14: the three mesh-error estimators at 10,004 nodes, and the
    auto-scaled CartPole at 10,001 nodes."""
    from asset_asrl_torch.OptimalControl import mesh
    worst = {}
    for est in ("deboor", "residual", "integrator"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        errs = []
        for p in phases:
            p.MeshErrorEstimator = est
            errs.append(mesh.segment_errors(p))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        top = [float(e.max()) for e in errs]
        worst[est] = int(np.argmax(top))
        print(f"mesh estimator {est!r} on {sum(p.numNodes for p in phases)} "
              f"nodes ({[p.numSegs for p in phases]} segments): {secs:.3f} s,"
              f" largest error per phase {[f'{e:.3e}' for e in top]}")
        check(all(np.isfinite(e).all() and e.shape == (p.numSegs,)
                  for e, p in zip(errs, phases)),
              f"estimator {est}: errors not finite")
    check(len(set(worst.values())) == 1,
          f"the estimators disagree on the worst phase: {worst}")

    # Auto-scaling with unit 1 on every variable scales the rows only, so
    # the physical objective is the unscaled solve's.  The guess holds a
    # control of 1: with a control of 0 the integral objective has a zero
    # Jacobian at the guess and gets the largest scale there is, in the JAX
    # package too.  Both solves stop at a KKT error of 1e-6, which pins the
    # objective to about 1e-8: the check is 1e-7 relative.
    ph = build_cartpole(ast, 5000, u0=1.0)
    ph.setAutoScaling(True)
    ph.setUnits(np.ones(6))
    ph.optimizer.set_PrintLevel(2)
    ph.optimizer.UseFused = False       # against phase 6's host loop
    flag, n1, nw, secs = counted(ck, ph.optimize)
    obj = ph.optimizer.LastObjVal
    print(f"auto-scaled CartPole ({ph.numNodes} nodes, unit 1): flag {flag} "
          f"iters {ph.optimizer.LastIterNum} obj {obj:.15f} (unscaled "
          f"{obj_unscaled:.15f}, objective scale {ph._obj_scale:.6e}), "
          f"{secs:.3f} s, K1 launches {n1}")
    check(flag == 0, "auto-scaled CartPole did not converge")
    check(abs(obj - obj_unscaled) <= 1e-7 * obj_unscaled,
          "auto-scaled CartPole: objective differs from the unscaled one")
    check(n1 > 0, "auto-scaled CartPole never launched K1")
    return n1, nw


def fused_line(opt, secs):
    """Time-to-solution, rates and host reads of the last fused solve."""
    it = opt.LastIterNum
    st = opt.LastFusedStats
    return (f"{secs:.3f} s, {it / secs:.3f} iterations/s, "
            f"{st['factorizations'] / it:.3f} factorizations and "
            f"{st['syncs'] / it:.3f} host reads per iteration")


def phase_default_solve(ast, ck):
    """Phase 15: the default solve, the fused loop, against the JAX
    package's default solve.  Objectives to 1e-9 relative (1e-8 at
    10,001 nodes, where both stop at a KKT error of 1e-6), the init
    multipliers to 1e-9.  Returns the K1 launches (narrow, wide) of the
    two-phase formation flying and the 10,001-node solves."""
    for name, ph in (("Brachistochrone LGL3 24",
                      build_brachistochrone(ast, "LGL3", 24)),
                     ("CartPole LGL5 40", build_cartpole(ast, 40))):
        rflag, rit, robj = FUSED[name]
        opt = ph.optimizer
        opt.set_PrintLevel(2)
        check(opt.UseFused and opt.InitLmults, "the default is not fused")
        flag, n1, _, secs = counted(ck, ph.optimize)
        obj = opt.LastObjVal
        print(f"default solve, {name}: flag {flag} iters {opt.LastIterNum} "
              f"obj {obj:.16f} (JAX default {robj:.16f}), K1 launches {n1}, "
              f"{fused_line(opt, secs)}")
        check(flag == rflag and opt.LastIterNum == rit,
              f"default solve {name}: flag/iterations")
        check(abs(obj - robj) <= 1e-9 * robj, f"default solve {name}: obj")
        check(n1 > 0, f"default solve {name}: K1 never launched")

    ocp, pa, pb = build_formation(ast, 256)
    opt = ocp.optimizer
    opt.set_PrintLevel(2)
    check(opt.UseFused and opt.InitLmults, "the OCP default is not fused")
    flag, n1, nw, secs = counted(ck, ocp.optimize)
    rflag, rit, robj = FUSED["formation 256"]
    obj = opt.LastObjVal
    print(f"default solve, formation flying 256 segs (b {opt.kkt.bs.b}): "
          f"flag {flag} iters {opt.LastIterNum} obj {obj:.16f} (JAX default "
          f"{robj:.16f}), K1 launches {n1} narrow / {nw} wide, "
          f"{fused_line(opt, secs)}")
    check(flag == rflag and opt.LastIterNum == rit,
          "default solve, formation flying: flag/iterations")
    check(abs(obj - robj) <= 1e-9 * robj,
          "default solve, formation flying: objective")
    check(nw > 0, "default solve, formation flying: wide K1 never launched")
    gap = np.asarray(pb.returnTraj())[:, 0] - np.asarray(pa.returnTraj())[:, 0]
    check(np.abs(gap - 0.2).max() < 1e-6, "formation offset not held")
    out = {"default (fused) solve, formation flying 256 segments": (n1, nw)}

    ph = build_cartpole(ast, 40, u0=1.0)
    ph.optimizer.set_PrintLevel(2)
    ph.transcribe()
    lamE = ph.optimizer.init(ph.makeSolverInput())[2]
    rnorm, rfirst, rarg = INIT_40
    norm = float(np.linalg.norm(lamE))
    print(f"PSIOPT.init, CartPole 40 segments, control guess 1: |lamE| "
          f"{norm:.16f} (JAX {rnorm:.16f}), lamE[:4] {lamE[:4].tolist()}, "
          f"largest at {int(np.abs(lamE).argmax())}")
    check(abs(norm - rnorm) <= 1e-9 * rnorm
          and np.abs(lamE[:4] - rfirst).max() <= 1e-9 * rnorm
          and int(np.abs(lamE).argmax()) == rarg, "PSIOPT.init off")

    ph = build_brachistochrone(ast, "LGL3", 24)
    opt = ph.optimizer
    opt.set_PrintLevel(2)
    opt.MaxIters, opt.ReturnBest = 4, True
    flag = ph.optimize()
    rflag, rit, robj = RETURN_BEST
    print(f"ReturnBest, Brachistochrone capped at 4 iterations: flag {flag} "
          f"iters {opt.LastIterNum} obj {opt.LastObjVal:.16f} (JAX "
          f"{robj:.16f})")
    check(flag == rflag and opt.LastIterNum == rit
          and abs(opt.LastObjVal - robj) <= 1e-9 * robj, "ReturnBest off")

    reset_peak_memory()
    ph = build_cartpole(ast, 5000)
    opt = ph.optimizer
    opt.set_PrintLevel(1)
    ph.transcribe()
    flag, n1, nw, secs = counted(ck, ph.optimize)
    peak = torch.cuda.max_memory_allocated()
    obj = opt.LastObjVal
    rflag, rit, robj = FUSED["CartPole LGL5 5000"]
    print(f"default solve, CartPole 5000 segs ({ph.numNodes} nodes): flag "
          f"{flag} iters {opt.LastIterNum} obj {obj:.15f} (JAX default "
          f"{robj:.15f}), K1 launches {n1}")
    print(f"  time-to-solution {fused_line(opt, secs)}; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    dev = ast.config.DEVICE
    state = [ast.config.tensor(a, dev) for a in (
        ph.makeSolverInput(), opt.LastSlacks, opt.LastEqLmults,
        opt.LastIqLmults)]
    st = opt.measure_stage_times(*state, opt.initMu, opt.ObjScale)
    print("  stage times at the solution (LastStageTimes, ms): " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in st.items()))
    check(flag == rflag and opt.LastIterNum == rit,
          "default solve at 10,001 nodes: flag/iterations")
    check(abs(obj - robj) <= 1e-8 * robj,
          "default solve at 10,001 nodes: objective")
    check(n1 > 0, "default solve at 10,001 nodes: K1 never launched")
    out["default (fused) solve, CartPole 10,001 nodes"] = (n1, nw)
    return out


@contextlib.contextmanager
def k1_log(kb):
    """Record the (blocks, width) of every K1 launch the block KKT makes
    inside the block."""
    shapes = []
    plain = kb.gj_inverse_inertia

    def spy(D):
        shapes.append(tuple(D.shape[:2]))
        return plain(D)
    kb.gj_inverse_inertia = spy
    try:
        yield shapes
    finally:
        kb.gj_inverse_inertia = plain


def run_ensemble(ast, ck, kb, name, ph, perts, ref=None):
    """One solve_ensemble on the card; every K1 launch must cover every
    lane, and lane 0 and the lane with the most iterations, solved alone
    through optimize(), must equal their lanes (flag and iterations, the
    objective to 1e-9 relative).  Returns the K1 launches (narrow,
    wide)."""
    from asset_asrl_torch.parallel import solve_ensemble
    B = len(perts)
    base = ph.makeSolverInput()
    reset_peak_memory()
    with k1_log(kb) as shapes:
        res, n1, nw, secs = counted(ck, lambda: solve_ensemble(
            ph, perturb_states=perts))
    peak = torch.cuda.max_memory_allocated()
    st = ph.optimizer.LastFusedStats
    iters = res["iters"]
    print(f"{name} ensemble, {B} scenarios: flags "
          f"{np.bincount(res['flags'], minlength=4).tolist()}, iterations "
          f"{iters.min()}..{iters.max()} ({iters.sum()} lane-iterations), "
          f"{secs:.3f} s: {B / secs:.2f} scenarios/s, "
          f"{iters.sum() / secs:.2f} lane-iterations/s; {st['iterations']} "
          f"batched iterations, {st['factorizations']} factorizations, "
          f"{st['syncs']} host reads; peak device memory "
          f"{peak / 2**20:.1f} MiB; K1 launches {n1} narrow / {nw} wide")
    counts = {}
    for k in shapes:
        counts[k] = counts.get(k, 0) + 1
    print("  K1 launch shapes (blocks, width): count " + ", ".join(
        f"{k}: {v}" for k, v in sorted(counts.items(), reverse=True)))
    check(np.isfinite(res["x"]).all() and res["x"].shape == (B, base.size),
          f"{name} ensemble: x")
    check(n1 + nw == len(shapes) > 0
          and all(k % B == 0 for k, _ in shapes),
          f"{name} ensemble: a K1 launch does not cover every lane")
    if ref is not None:
        rflag, rit, robjs = ref
        dev = np.abs(res["objs"][:len(robjs)] - robjs).max()
        print(f"  against the JAX package's ensemble: objectives of lanes "
              f"0-{len(robjs) - 1} within {dev:.3e}")
        check((res["flags"] == rflag).all() and (iters == rit).all(),
              f"{name} ensemble: flags/iterations differ from JAX")
        check(dev <= 1e-9 * max(abs(r) for r in robjs),
              f"{name} ensemble: objectives differ from JAX")
    opt = ph.optimizer
    for i in sorted({0, int(np.argmax(iters))}):
        t0 = time.perf_counter()
        opt.optimize(base + perts[i])
        secs = time.perf_counter() - t0
        robj = float(res["objs"][i])
        print(f"  lane {i} alone: flag {opt.ConvergeFlag} iters "
              f"{opt.LastIterNum} obj {opt.LastObjVal:.16f} (in the batch: "
              f"flag {res['flags'][i]} iters {iters[i]} obj {robj:.16f}), "
              f"{secs:.3f} s")
        check(opt.ConvergeFlag == res["flags"][i]
              and opt.LastIterNum == iters[i],
              f"{name} ensemble: lane {i} differs from its solo solve")
        check(abs(opt.LastObjVal - robj) <= 1e-9 * abs(robj),
              f"{name} ensemble: lane {i} objective")
    return n1, nw


def phase_ensembles(ast, ck, kb):
    """Phase 16: the MultiSpacecraft leg at 512 scenarios (perturbations
    default_rng(7) x 1e-4 about the solved baseline, as the example) and
    the 10,001-node CartPole at 16 scenarios (default_rng(3) x 1e-3 on the
    initial guess, as `tests/test_parallel.py`).  Returns the K1 launches
    (narrow, wide) of each."""
    ph = build_multispacecraft(ast)
    ph.optimizer.set_PrintLevel(2)
    flag = ph.optimize()
    rflag, rit, robj = MSC_BASE
    print(f"MultiSpacecraft baseline (LGL3, 12 segments, n "
          f"{ph._nlp.numPrimal}): flag {flag} iters "
          f"{ph.optimizer.LastIterNum} obj {ph.optimizer.LastObjVal:.16f} "
          f"(JAX default {robj:.16f})")
    check(flag == rflag and ph.optimizer.LastIterNum == rit
          and abs(ph.optimizer.LastObjVal - robj) <= 1e-9 * robj,
          "MultiSpacecraft baseline")
    base = ph.makeSolverInput()
    rng = np.random.default_rng(7)
    perts = [rng.normal(size=base.shape) * 1e-4 for _ in range(512)]
    out = {"MultiSpacecraft ensemble, 512 scenarios": run_ensemble(
        ast, ck, kb, "MultiSpacecraft", ph, perts, MSC_512)}

    ph = build_cartpole(ast, 5000)
    ph.optimizer.set_PrintLevel(2)
    ph.transcribe()
    base = ph.makeSolverInput()
    rng = np.random.default_rng(3)
    perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(16)]
    out["CartPole ensemble, 10,001 nodes, 16 scenarios"] = run_ensemble(
        ast, ck, kb, "CartPole 10,001 nodes", ph, perts)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    import asset_asrl_torch as ast
    from asset_asrl_torch.Solvers import cuda_kernels as ck
    from asset_asrl_torch.Solvers import kkt_block as kb
    check(ast.config.DEVICE.type == "cuda", "port did not pick the card")

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    ck.build()
    print(f"build: K1 compiled and loaded in {time.perf_counter() - t0:.2f} s")
    print_ptxas(ck)

    k1 = phase_kernel(ck)
    phase_bcr(kb)
    phase_slice40(ast, ck)
    obj_5000 = phase_slice5000(ast, ck)
    phase_breadth(ast, ck)
    wide = {n: phase_formation(ast, ck, n) for n in (80, 256, 512)}[256]
    phase_delta3_40(ast, ck)
    narrow, d3_phases = phase_delta3_full(ast, ck)
    phase_integrator(ast)
    adaptive = {"hypersensitive, adaptive mesh": phase_hypersens(ast, ck),
                "Delta III, adaptive mesh": phase_delta3_adaptive(ast, ck)}
    adaptive["auto-scaled CartPole, 10,001 nodes"] = phase_estimators(
        ast, ck, d3_phases, obj_5000)
    del d3_phases
    adaptive.update(phase_default_solve(ast, ck))
    adaptive.update(phase_ensembles(ast, ck, kb))

    launches = {"gj_inverse": narrow, "gj_inverse_wide": wide}
    # the launches of the solves of phases 12 to 16
    more = {"gj_inverse": {k: n for k, (n, _) in adaptive.items()},
            "gj_inverse_wide": {k: n for k, (_, n) in adaptive.items()}}
    source = {"gj_inverse": "asset_asrl_torch/csrc/gj_inverse.cu",
              "gj_inverse_wide": "asset_asrl_torch/csrc/gj_inverse_wide.cu"}

    print(f"all phases: {time.perf_counter() - t_start:.1f} s")

    def shapes_of(is_wide):
        return [dict(shape=[K, W, W], **m) for (K, W), m in k1.items()
                if (W > ck.MAX_W) == is_wide]
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=source[name],
        replaces="asset_asrl_tpu/Solvers/pallas_kernels.py:103",
        launches=launches[name], launches_from=run,
        launches_elsewhere=more[name], shape=[K, W, W],
        **k1[(K, W)], shapes=shapes_of(W > ck.MAX_W))
        for (K, W), (name, run) in K1_MAIN.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
