#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`asset_asrl_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. device: a CUDA card must be visible; prints its name, power limit and
   the torch / CUDA versions;
2. build: compiles kernel K1 (`asset_asrl_torch/csrc/gj_inverse.cu`);
3. K1 against its plain PyTorch version on seeded symmetric
   quasi-definite blocks, f64 and f32, at the block-cyclic-reduction
   shapes of the 10,001-node problem (narrow kernel) and at border widths
   85 to 511 (wide kernel), each timed with CUDA events at one shape;
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
8. formation flying (two phases, PathToPath link) at 80 segments per
   phase: the 85-wide border goes through the wide K1 kernel;
9. the 4-phase Delta III launch at 40 segments per phase through
   `ocp.solve_optimize()`, and a bitwise repeatability check of one
   factorization;
10. Delta III at 2500 segments per phase (10,004 nodes), with
   time-to-solution, iterations/s and peak device memory.

Every phase resets the K1 launch counts just before it drives its problem
and reads them just after.  The line before the last is a JSON object
describing every kernel of the main path (narrow K1 launches from phase
10, wide K1 launches from phase 8); the last line is the JSON device
record.
"""

import json
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
             80: (0, 3, 3.0009299750648717, 85)}
# Delta III, LGL3 segments per phase -> (flag, iterations of
# solve_optimize, final mass in kg)
DELTA3 = {40: (0, 40, 7529.748664196064),
          2500: (0, 53, 7528.398909956162)}


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


def build_cartpole(ast, nsegs, tmode="LGL5", cmode=None):
    """The CartPole swing-up phase of the repository's benchmark (LGL5,
    default control mode unless `cmode` is given), built with either
    package's namespace."""
    vf = ast.VectorFunctions
    tf, xf = 2.0, 1.0
    ts = np.linspace(0, tf, 100)
    IG = [[xf * t / tf, np.pi * t / tf, 0, 0, t, .0] for t in ts]
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


def build_delta3(ast, nsegs):
    """The 4-phase Delta III launch of `tests/test_delta3.py` on a fixed
    mesh of `nsegs` LGL3 segments per phase (no adaptive mesh), with the
    test's L1 line searches and MaxLSIters 2, built with either package's
    namespace.  Returns (ocp, phases)."""
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
    return ocp, phases


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


def phase_kernel(ck):
    """Phase 3: K1 (narrow kernel up to W = 64, wide kernel above)
    against gj_inverse_ref, f64 and f32.  Returns the measurements of the
    narrow kernel at (2500,24,24) and of the wide one at (1,255,255)."""
    out = {}
    timed = {(2500, 24): "gj_inverse", (1, 255): "gj_inverse_wide"}
    shapes = [(2500, 24), (1250, 24), (1, 24), (1, 2), (3, 64),
              (1, 85), (1, 160), (1, 255), (2, 511)]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for i, (K, W) in enumerate(shapes):
            D = quasi_definite_blocks(K, W, seed=100 + i, dtype=dtype)
            n0, w0 = ck.gj_inverse.launches, ck.gj_inverse.wide_launches
            X, p = ck.gj_inverse(D)
            Xr, pr = ck.gj_inverse_ref(D)
            torch.cuda.synchronize()
            wide = W > ck.MAX_W
            check((ck.gj_inverse.wide_launches - w0,
                   ck.gj_inverse.launches - n0) == ((1, 0) if wide
                                                    else (0, 1)),
                  f"K1 at width {W} did not launch the expected kernel")
            ex, ep = rel(X, Xr), rel(p, pr)
            signs = bool(torch.equal(torch.sign(p), torch.sign(pr)))
            print(f"K1{' wide' if wide else ''} {str(dtype)[6:]} "
                  f"({K},{W},{W}): inverse rel {ex:.3e}  pivots rel "
                  f"{ep:.3e}  signs equal {signs}")
            check(ex <= tol and ep <= tol and signs,
                  f"K1 disagrees with its plain version at ({K},{W}) "
                  f"{dtype}")
            name = timed.get((K, W))
            if dtype == torch.float64 and name:
                out[name] = dict(
                    max_abs_err=float((X - Xr).abs().max()),
                    ms=cuda_ms(lambda: ck.gj_inverse(D)),
                    plain_ms=cuda_ms(lambda: ck.gj_inverse_ref(D)))
                print(f"K1 {name} ({K},{W},{W}) f64: kernel "
                      f"{out[name]['ms']:.4f} ms, plain "
                      f"{out[name]['plain_ms']:.4f} ms (median of 20, "
                      f"CUDA events)")
    return out


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
        fac, neigs = kb.bcr_factor(*t[:4])
        At = t[4]
        r = torch.tensor(rng.normal(size=(K, W)), dtype=torch.float64,
                         device="cuda")
        rb = torch.tensor(rng.normal(size=(b,)), dtype=torch.float64,
                          device="cuda")
        y, z = kb.bcr_solve(fac, r, rb)
        ref = torch.linalg.solve(At, torch.cat([r.reshape(-1), rb]))
        err = rel(torch.cat([y.reshape(-1), z]), ref)
        nneg = int((torch.linalg.eigvalsh(At) < 0).sum())
        print(f"BCR (64,24,2) seed {seed}: solve rel {err:.3e}, inertia "
              f"{int(neigs)} vs eigvalsh {nneg}")
        check(err < 1e-8, "BCR solve disagrees with the dense solve")
        check(int(neigs) == nneg, "BCR inertia disagrees with eigvalsh")


def run_phase(ast, ck, nsegs):
    ph = build_cartpole(ast, nsegs)
    ph.optimizer.set_PrintLevel(1)
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
    torch.cuda.reset_peak_memory_stats()
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
    return launches


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


def phase_formation(ast, ck, nsegs=80):
    """Phase 8: formation flying with a PathToPath link; the border
    (b = segments + 5) is wider than 64, so it goes through the wide K1
    kernel."""
    rflag, rit, robj, rb = FORMATION[nsegs]
    ocp, pa, pb = build_formation(ast, nsegs)
    ocp.optimizer.set_PrintLevel(2)
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
    torch.cuda.reset_peak_memory_stats()
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
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    import asset_asrl_torch as ast
    from asset_asrl_torch.Solvers import cuda_kernels as ck
    from asset_asrl_torch.Solvers import kkt_block as kb
    check(ast.config.DEVICE.type == "cuda", "port did not pick the card")

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

    k1 = phase_kernel(ck)
    phase_bcr(kb)
    phase_slice40(ast, ck)
    phase_slice5000(ast, ck)
    phase_breadth(ast, ck)
    wide = phase_formation(ast, ck)
    phase_delta3_40(ast, ck)
    narrow = phase_delta3_full(ast, ck)

    launches = {"gj_inverse": narrow, "gj_inverse_wide": wide}
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda",
        source="asset_asrl_torch/csrc/gj_inverse.cu",
        replaces="asset_asrl_tpu/Solvers/pallas_kernels.py:103",
        launches=launches[name], **k1[name]) for name in launches]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
