#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port (`asset_asrl_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on failure:

1. device: a CUDA card must be visible; prints its name, power limit and
   the torch / CUDA versions;
2. build: compiles kernel K1 (`asset_asrl_torch/csrc/gj_inverse.cu`);
3. K1 against its plain PyTorch version on seeded symmetric
   quasi-definite blocks, f64 and f32, at the block-cyclic-reduction
   shapes of the 10,001-node problem, and both timed with CUDA events;
4. BCR factor/solve on the card against a dense solve and eigvalsh
   inertia;
5. the CartPole swing-up (LGL5, 40 segments) through `phase.optimize()`
   against its known flag / iterations / objective, and a bitwise
   repeatability check of one factorization;
6. the same problem at 5000 segments (10,001 collocation nodes), with
   time-to-solution, iterations/s and peak device memory.

The line before the last is a JSON object describing every kernel of the
main path; the last line is the JSON device record.
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


def build_cartpole(ast, nsegs, tmode="LGL5"):
    """The CartPole swing-up phase (default control mode) of the
    repository's benchmark (LGL5), built with either package's
    namespace."""
    vf = ast.VectorFunctions
    tf, xf = 2.0, 1.0
    ts = np.linspace(0, tf, 100)
    IG = [[xf * t / tf, np.pi * t / tf, 0, 0, t, .0] for t in ts]
    phase = cartpole_ode(ast).phase(tmode, IG, nsegs)
    phase.addBoundaryValue("First", range(0, 5), [0, 0, 0, 0, 0])
    phase.addBoundaryValue("Last", range(0, 5), [xf, np.pi, 0, 0, tf])
    phase.addLUVarBound("Path", 5, -20.0, 20.0)
    phase.addLUVarBound("Path", 0, -2.0, 2.0)
    phase.addIntegralObjective(vf.Arguments(1)[0] ** 2, [5])
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


def phase_kernel(ck):
    """Phase 3: K1 against gj_inverse_ref, f64 and f32."""
    out = {}
    shapes = [(2500, 24), (1250, 24), (1, 24), (1, 2), (3, 64)]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for i, (K, W) in enumerate(shapes):
            D = quasi_definite_blocks(K, W, seed=100 + i, dtype=dtype)
            X, p = ck.gj_inverse(D)
            Xr, pr = ck.gj_inverse_ref(D)
            torch.cuda.synchronize()
            ex, ep = rel(X, Xr), rel(p, pr)
            signs = bool(torch.equal(torch.sign(p), torch.sign(pr)))
            print(f"K1 {str(dtype)[6:]} ({K},{W},{W}): inverse rel "
                  f"{ex:.3e}  pivots rel {ep:.3e}  signs equal {signs}")
            check(ex <= tol and ep <= tol and signs,
                  f"K1 disagrees with its plain version at ({K},{W}) "
                  f"{dtype}")
            if dtype == torch.float64 and (K, W) == (2500, 24):
                out["max_abs_err"] = float((X - Xr).abs().max())
                out["ms"] = cuda_ms(lambda: ck.gj_inverse(D))
                out["plain_ms"] = cuda_ms(lambda: ck.gj_inverse_ref(D))
    print(f"K1 (2500,24,24) f64: kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms (median of 20, CUDA events)")
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

    kkt = opt.kkt
    x = torch.tensor(ph.makeSolverInput(), dtype=torch.float64,
                     device="cuda")
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
    launches = phase_slice5000(ast, ck)

    print(json.dumps({"kernels": [dict(
        name="gj_inverse", route="cuda",
        source="asset_asrl_torch/csrc/gj_inverse.cu",
        replaces="asset_asrl_tpu/Solvers/pallas_kernels.py:103",
        launches=launches, max_abs_err=k1["max_abs_err"], ms=k1["ms"],
        plain_ms=k1["plain_ms"])]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
