"""PSIOPT: primal-dual interior-point NLP solver.

Port of `asset_asrl_tpu/Solvers/psiopt.py`: slacks per inequality, LOQO /
PROBE barrier updates, fraction-to-boundary, merit line search, slack
reset, the inertia-corrected factorization ladder (deltaH/incrH/decrH) and
the convergence tiers (CONVERGED / ACCEPTABLE / NOTCONVERGED / DIVERGING).

The KKT system is reduced by analytic slack elimination to the symmetric
quasi-definite form [[H+dI, JE^T, JI^T], [JE, -gI, 0], [JI, 0, -(1/Sig+g)]]
and factored by the block-tridiagonal backend (`kkt_block.BlockKKT`, or
`kkt_sharded.ShardedBlockKKT` over a mesh), or by the dense backend (`kkt_dense.DenseKKT`) when the problem's structure does
not fit the block one.

Two loops, as in the JAX package: with `UseFused` (the default) a block
KKT runs the fused algorithm of `fused.py` (the equality multipliers start
from the least-squares estimate when `InitLmults`; the family AD runs once
an iteration and the ladder refactors assembled blocks).  The dense
backend, and `UseFused = False`, run the host loop `_alg_impl`, which
re-runs the AD at every ladder refactor and reads a few scalars per
iteration (the debugging path).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import config
from ..Utils import span
from .fused import INFO_FIELDS, _maxstep, _sigma_diag, _slack_reset, \
    build_fused_alg, init_multipliers
from .kkt_block import BlockKKT
from .kkt_sharded import ShardedBlockKKT
from .nlp import NonLinearProgram

__all__ = ["PSIOPT", "ConvergenceFlags"]

# the backends of the block structure: the fused loop, the least-squares
# multiplier start, the stage timings and storespmat run on either
BLOCK_BACKENDS = (BlockKKT, ShardedBlockKKT)

# profiler ranges (`Utils.span`) of a solve's passes, by mode
_PASS_SPANS = {m: f"asset.psiopt.pass.{m}" for m in ("SOE", "OPTNO", "OPT")}


class ConvergenceFlags:
    CONVERGED = 0
    ACCEPTABLE = 1
    NOTCONVERGED = 2
    DIVERGING = 3

    _names = {0: "CONVERGED", 1: "ACCEPTABLE", 2: "NOTCONVERGED",
              3: "DIVERGING"}


def _max_step_to_boundary(v, dv, bfrac):
    """max alpha <= 1 with v + alpha*dv >= (1-bfrac)*v, on the host."""
    return float(_maxstep(v, dv, bfrac))


def _np(t):
    return t.detach().cpu().numpy()


class PSIOPT:
    """Interior-point optimizer over a NonLinearProgram."""

    def __init__(self, nlp: NonLinearProgram | None = None, kkt=None):
        # --- tolerance / algorithm knobs, names follow the reference ---
        self.MaxIters = 500
        self.MaxAccIters = 50
        self.MaxLSIters = 2
        self.MaxRefac = 15
        self.KKTtol = 1.0e-6
        self.EContol = 1.0e-6
        self.IContol = 1.0e-6
        self.Bartol = 1.0e-6
        self.AccKKTtol = 1.0e-2
        self.AccEContol = 1.0e-3
        self.AccIContol = 1.0e-3
        self.AccBartol = 1.0e-3
        self.DivKKTtol = 1.0e15
        self.DivEContol = 1.0e15
        self.DivIContol = 1.0e15
        self.DivBartol = 1.0e15
        self.BoundFraction = 0.99
        self.BoundPush = 1.0e-3
        self.NegSlackReset = 1.0e-12
        self.deltaH = 1.0e-5
        self.incrH = 8.0
        self.decrH = 1.0 / 3.0
        self.initMu = 1.0e-3
        self.MaxMu = 100.0
        self.MinMu = 1.0e-12
        self.ObjScale = 1.0
        self.alphaRed = 2.0
        self.OptBarMode = "LOQO"
        self.SoeBarMode = "LOQO"
        self.OptLSMode = "AUGLANG"
        self.SoeLSMode = "NOLS"
        # SoeMode: algorithm run by solve() passes: "SOE" (first-order
        # feasibility steps) or "OPTNO" (constraint Hessians, no objective)
        self.SoeMode = "SOE"
        # PrimSlackEq_Iq | AllMinimum | PrimSlack_EqIq | MaxEq
        self.PDStepStrategy = "PrimSlackEq_Iq"
        # Mehrotra second-order correction in PROBE barrier mode
        self.ProbeCorrector = True
        # start each pass's equality multipliers from the least-squares
        # estimate (`init`), on the fused loop
        self.InitLmults = True
        self.PrintLevel = 0
        self.FastFactorAlg = True
        self.gammaE = 1.0e-10   # dual regularization (quasi-definiteness)
        self.gammaI = 1.0e-10
        self.CNRMode = False          # no ANSI colors in the iterate table
        self.WideConsole = False      # iterate table with nfacs and Hpert
        # keep the KKT blocks (diag, lower, B, C) of the final iterate of
        # each pass in LastKKTBlocks
        self.storespmat = False
        self.LastKKTBlocks = None
        # on the fused loop, return the best iterate (BestCriteria: ECons,
        # KKT or ObjVal) of a pass that ended neither CONVERGED nor
        # ACCEPTABLE
        self.ReturnBest = False
        self.BestCriteria = "ECons"
        # callbacks, called with a dict: EarlyCallBack after every host-loop
        # iteration, LateCallBack once per fused pass with its `infos`
        # history (a per-iteration callback would read the device each
        # iteration)
        self.EarlyCallBack = None
        self.LateCallBack = None
        # the fused loop for block KKTs; False: the host loop
        self.UseFused = True
        # `measure_stage_times`' last probe (seconds by stage)
        self.LastStageTimes = None
        # start from the previous solve's multipliers and slacks
        self.WarmStart = False

        # --- outputs ---
        self.LastObjVal = 0.0
        self.LastIterNum = 0
        self.LastTotalTime = 0.0
        # host seconds of function evaluations (family AD and value
        # passes) and of the KKT (assembly, factor, solve) over the passes
        # of the last solve; timed inside the loop on either path
        self.LastFuncTime = 0.0
        self.LastKKTTime = 0.0
        # the fused passes of the last solve, summed: outer iterations,
        # host reads, factorizations, K1 launches, family-AD passes and
        # line searches replayed and run eagerly, and host seconds by stage
        # (`fused.build_fused_alg` stats); with `passes`, the SOE-mode
        # passes' own `soe_iterations` and `soe_s` (their `loop_s`), and
        # `run_s`, the host seconds of the whole solve.  None after a solve
        # with no fused pass.
        self.LastFusedStats = None
        self.ConvergeFlag = ConvergenceFlags.NOTCONVERGED
        self.LastEqLmults = None
        self.LastIqLmults = None
        self.LastSlacks = None

        self.nlp = nlp
        self.kkt = kkt

    # ---------------------------------------------------------------- knobs
    def set_OptLSMode(self, m):
        self.OptLSMode = m

    def set_SoeLSMode(self, m):
        self.SoeLSMode = m

    def set_OptBarMode(self, m):
        self.OptBarMode = m

    def set_SoeBarMode(self, m):
        self.SoeBarMode = m

    def set_PrintLevel(self, p):
        self.PrintLevel = int(p)

    def set_SoeMode(self, m):
        m = str(m)
        if m not in ("SOE", "OPTNO"):
            raise ValueError("SoeMode must be SOE or OPTNO")
        self.SoeMode = m

    def set_PDStepStrategy(self, m):
        m = str(m)
        if m not in ("PrimSlackEq_Iq", "AllMinimum", "PrimSlack_EqIq",
                     "MaxEq"):
            raise ValueError(f"unknown PDStepStrategy {m}")
        self.PDStepStrategy = m

    def set_MaxIters(self, n):
        self.MaxIters = int(n)

    def set_MaxAccIters(self, n):
        self.MaxAccIters = int(n)

    def set_MaxLSIters(self, n):
        self.MaxLSIters = int(n)

    def set_tols(self, KKTtol=None, EContol=None, IContol=None, Bartol=None):
        if KKTtol is not None:
            self.KKTtol = abs(KKTtol)
        if EContol is not None:
            self.EContol = abs(EContol)
        if IContol is not None:
            self.IContol = abs(IContol)
        if Bartol is not None:
            self.Bartol = abs(Bartol)

    def set_Acctols(self, k, e, i, b):
        self.AccKKTtol, self.AccEContol = abs(k), abs(e)
        self.AccIContol, self.AccBartol = abs(i), abs(b)

    def set_KKTtol(self, v):
        self.KKTtol = abs(v)

    def set_EContol(self, v):
        self.EContol = abs(v)

    def set_IContol(self, v):
        self.IContol = abs(v)

    def set_Bartol(self, v):
        self.Bartol = abs(v)

    def set_BoundFraction(self, v):
        self.BoundFraction = v

    def set_deltaH(self, v):
        self.deltaH = abs(v)

    def set_QPOrderingMode(self, *_):
        pass  # no sparse ordering in the block or dense backends

    def set_QPParams(self, *_, **__):
        pass

    def setNLP(self, nlp, kkt=None):
        self.nlp = nlp
        self.kkt = kkt

    # ------------------------------------------------------------- slack init
    def _init_state(self, x, mu):
        """Slacks from constraint values with BoundPush floor; iq
        multipliers mu/s; eq multipliers 0."""
        nlp = self.nlp
        dev = nlp.device
        x = config.tensor(x, dev)
        _, cE, cI = nlp.eval_obj_cons(x)
        if nlp.numIq > 0:
            cI = _np(cI)
            s = np.where(cI < -self.BoundPush, np.abs(cI), self.BoundPush)
            lamI = config.tensor(mu / s, dev)
            s = config.tensor(s, dev)
        else:
            s = torch.zeros((0,), dtype=config.DTYPE, device=dev)
            lamI = torch.zeros((0,), dtype=config.DTYPE, device=dev)
        lamE = torch.zeros((nlp.numEq,), dtype=config.DTYPE, device=dev)
        return x, s, lamE, lamI

    # ------------------------------------------------------------ public API
    def init(self, x):
        """The INIT pass: slacks and inequality multipliers from the
        constraint values, and the least-squares estimate of the equality
        multipliers from one first-order factorization (unit primal
        diagonal, zero Hessian), stored for a WarmStart of the next solve.
        Returns (x, s, lamE, lamI) as numpy arrays."""
        self.nlp.freeze()
        if self.kkt is None:
            from .kkt_dense import DenseKKT
            self.kkt = DenseKKT(self.nlp)
        x, s, lamE, lamI = self._init_state(np.asarray(x, np.float64),
                                            self.initMu)
        nlp, kkt, dev = self.nlp, self.kkt, self.nlp.device
        mE, mI = nlp.numEq, nlp.numIq
        if mE > 0 and isinstance(kkt, BLOCK_BACKENDS):
            lamE0 = init_multipliers(kkt, x[None], self.ObjScale,
                                     self.gammaE, nlp.consts_dev())[0]
            if bool(torch.isfinite(lamE0).all()):
                lamE = lamE0
        elif mE > 0:
            # dense: factor at unit perturbation, first-order rhs
            zE = torch.zeros((mE,), dtype=config.DTYPE, device=dev)
            zI = torch.zeros((mI,), dtype=config.DTYPE, device=dev)
            _, _, _, _, rd = kkt.eval_resid(x, zE, zI, self.ObjScale)
            fac, _ = kkt.factor(x, zE, zI, self.ObjScale,
                                torch.ones_like(zI), 1.0, self.gammaE)
            _, lamE0 = kkt.solve(fac, -rd, zE)
            if bool(torch.isfinite(lamE0).all()):
                lamE = lamE0
        self.LastEqLmults = _np(lamE)
        self.LastIqLmults = _np(lamI)
        self.LastSlacks = _np(s)
        return _np(x), _np(s), _np(lamE), _np(lamI)

    def solve(self, x):
        """Feasibility pass (SoeMode)."""
        return self._run(x, ["SOE"])

    def optimize(self, x):
        return self._run(x, ["OPT"])

    def solve_optimize(self, x):
        return self._run(x, ["SOE", "OPT"])

    def solve_optimize_solve(self, x):
        return self._run(x, ["SOE", "OPT", "SOE"])

    def optimize_solve(self, x):
        return self._run(x, ["OPT", "SOE"])

    # ------------------------------------------------------------------- run
    def _run(self, x0, schedule):
        """Run the passes of `schedule` from x0.  LastIterNum counts the
        iterations of all passes."""
        self.nlp.freeze()
        if self.kkt is None:
            # the structure did not fit the block backend (or the dense
            # backend was asked for)
            from .kkt_dense import DenseKKT
            self.kkt = DenseKKT(self.nlp)
        t0 = time.perf_counter()
        self.LastIterNum = 0
        self.LastFuncTime = 0.0
        self.LastKKTTime = 0.0
        self.LastFusedStats = None
        x, s, lamE, lamI = self._init_state(np.asarray(x0, np.float64),
                                            self.initMu)
        nlp, dev = self.nlp, self.nlp.device
        self._warm_applied = False
        if self.WarmStart and self.LastEqLmults is not None \
                and len(self.LastEqLmults) == nlp.numEq \
                and self.LastIqLmults is not None \
                and len(self.LastIqLmults) == nlp.numIq:
            self._warm_applied = True
            lamE = config.tensor(self.LastEqLmults, dev)
            if nlp.numIq:
                lamI = torch.clamp(config.tensor(self.LastIqLmults, dev),
                                   min=1e-8)
                if self.LastSlacks is not None \
                        and len(self.LastSlacks) == nlp.numIq:
                    s = torch.clamp(config.tensor(self.LastSlacks, dev),
                                    min=self.BoundPush * 1e-3)
        alg = self._alg_fused if self.UseFused \
            and isinstance(self.kkt, BLOCK_BACKENDS) else self._alg_impl
        flag = ConvergenceFlags.NOTCONVERGED
        for mode in schedule:
            if mode == "SOE":
                mode = str(self.SoeMode)
            with span(_PASS_SPANS[mode]):
                x, s, lamE, lamI, flag = alg(mode, x, s, lamE, lamI)
            if flag == ConvergenceFlags.DIVERGING:
                break
        self.ConvergeFlag = flag
        self.LastEqLmults = _np(lamE)
        self.LastIqLmults = _np(lamI)
        self.LastSlacks = _np(s)
        obj, _, _ = self.nlp.eval_obj_cons(x)
        self.LastObjVal = float(obj)
        self.LastTotalTime = time.perf_counter() - t0
        if self.LastFusedStats is not None:
            self.LastFusedStats["run_s"] = self.LastTotalTime
        return _np(x)

    # ------------------------------------------------------ fused device loop
    def _opts_snapshot(self):
        keys = ("MaxIters", "MaxAccIters", "MaxLSIters", "MaxRefac",
                "KKTtol", "EContol", "IContol", "Bartol",
                "AccKKTtol", "AccEContol", "AccIContol", "AccBartol",
                "DivKKTtol", "DivEContol", "DivIContol", "DivBartol",
                "BoundFraction", "NegSlackReset", "deltaH", "incrH",
                "decrH", "initMu", "MaxMu", "MinMu", "ObjScale",
                "alphaRed", "OptBarMode", "SoeBarMode", "OptLSMode",
                "SoeLSMode", "FastFactorAlg", "gammaE", "gammaI",
                "BestCriteria", "PDStepStrategy", "InitLmults",
                "ProbeCorrector")
        return {k: getattr(self, k) for k in keys}

    def _alg_fused(self, mode, x, s, lamE, lamI):
        """One mode pass through the fused loop."""
        opts = self._opts_snapshot()
        # a warm start keeps the multipliers it was given
        opts["InitLmults"] = bool(self.InitLmults) \
            and not getattr(self, "_warm_applied", False)
        key = (mode, tuple(sorted(opts.items())), id(self.kkt))
        cache = getattr(self, "_fused_cache", None)
        if cache is None or cache[0] != key:
            self._fused_cache = (key, build_fused_alg(self.kkt, opts, mode))
        fn = self._fused_cache[1]
        sigma = 0.0 if mode in ("SOE", "OPTNO") else self.ObjScale
        out = fn(x[None], s[None], lamE[None], lamI[None], self.initMu,
                 self.nlp.consts_dev())
        (x, s, lamE, lamI, Mu, flag, niters, infos,
         bx, bs_, blE, blI) = (o[0] for o in out)
        flag, niters = int(flag), int(niters)
        st = fn.stats
        self._add_pass_stats(st, mode in ("SOE", "OPTNO"))
        self.LastFuncTime += st.get("ad_s", 0.0) + st.get("ls_s", 0.0)
        self.LastKKTTime += st.get("kkt_s", 0.0)
        infos = _np(infos[:max(niters, 1)])
        if self.ReturnBest and flag not in (ConvergenceFlags.CONVERGED,
                                            ConvergenceFlags.ACCEPTABLE):
            x, s, lamE, lamI = bx, bs_, blE, blI
        self.LastIterNum += niters
        if self.storespmat:
            self._store_spmat(x, s, lamE, lamI, float(Mu), sigma)
        if callable(self.LateCallBack):
            self.LateCallBack(dict(mode=mode, flag=flag, iters=niters,
                                   infos=infos, x=_np(x), lamE=_np(lamE),
                                   lamI=_np(lamI)))
        if self.PrintLevel == 0:
            self._print_iterate_table(mode, infos)
        if self.PrintLevel <= 1:
            r = infos[-1]
            print(f"PSIOPT [{mode}] {ConvergenceFlags._names[flag]} in "
                  f"{len(infos)} iters: obj {r[0]:+.8e} kkt {r[1]:.2e} "
                  f"econ {r[2]:.2e} icon {r[3]:.2e} barr {r[4]:.2e}")
        return x, s, lamE, lamI, flag

    def _add_pass_stats(self, st, soe):
        """Add one fused pass's counters `st` to LastFusedStats, the sum
        over the passes of the solve (every counter is a count or host
        seconds); `soe`: a pass of the SOE mode (sigma 0)."""
        tot = self.LastFusedStats
        if tot is None:
            tot = self.LastFusedStats = dict(passes=0, soe_iterations=0,
                                             soe_s=0.0)
        for k, v in st.items():
            tot[k] = tot.get(k, 0) + v
        tot["passes"] += 1
        if soe:
            tot["soe_iterations"] += st.get("iterations", 0)
            tot["soe_s"] += st.get("loop_s", 0.0)

    def _sig_tilde(self, s, lamI, Mu):
        if self.nlp.numIq == 0:
            return torch.zeros((0,), dtype=config.DTYPE, device=s.device)
        s_ = torch.clamp(s, min=1e-300)
        Sig = _sigma_diag(s_, lamI, Mu)
        return Sig / (1.0 + self.gammaI * Sig)

    def measure_stage_times(self, x, s, lamE, lamI, Mu, sigma):
        """Seconds of each stage of one fused iteration at the given
        iterate (family AD with Hessians, block assembly, regularize +
        factor, solve, line-search value pass): a warm call, then the mean
        of 3, each ending in a device synchronize.  Returns the dict (also
        stored in LastStageTimes); None for a dense KKT.  A probe outside
        any solve: the fused loop's own stage seconds are in
        LastFusedStats."""
        if not isinstance(self.kkt, BLOCK_BACKENDS):
            return None
        kkt, nlp = self.kkt, self.nlp
        consts = nlp.consts_dev()
        xb, sb, lEb, lIb = x[None], s[None], lamE[None], lamI[None]
        sig_tilde = self._sig_tilde(s, lamI, Mu)[None]
        cuda = x.device.type == "cuda"

        def timed(fn, *a, reps=3):
            out = fn(*a)            # warm
            if cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(*a)
            if cuda:
                torch.cuda.synchronize(x.device)
            return (time.perf_counter() - t0) / reps, out

        t_ad, adout = timed(kkt._eval_core, xb, lEb, lIb, float(sigma),
                            consts, True)
        t_blk, blocks = timed(kkt._blocks_impl, adout[4], sig_tilde)
        t_fac, facout = timed(kkt._factor_blocks_impl, blocks,
                              float(self.deltaH), float(self.gammaE))
        t_slv, _ = timed(kkt._solve_impl, facout[0], torch.zeros_like(xb),
                         torch.zeros_like(lEb))
        t_oc, _ = timed(nlp.eval_obj_cons_impl, xb, consts)
        self.LastStageTimes = dict(func_ad=t_ad, assembly=t_blk,
                                   factor=t_fac, solve=t_slv,
                                   value_pass=t_oc)
        return self.LastStageTimes

    def _store_spmat(self, x, s, lamE, lamI, Mu, sigma):
        """The KKT blocks (diag, lower, B, C) at the given iterate, as
        numpy arrays in LastKKTBlocks (block KKT only)."""
        if not isinstance(self.kkt, BLOCK_BACKENDS):
            return
        _, _, _, _, famvals = self.kkt._eval_core(
            x[None], lamE[None], lamI[None], float(sigma),
            self.nlp.consts_dev(), True)
        blocks = self.kkt._blocks_impl(famvals,
                                       self._sig_tilde(s, lamI, Mu)[None])
        self.LastKKTBlocks = tuple(_np(b[0]) for b in blocks)

    # --------------------------------------------------------- console table
    def _print_iterate_table(self, mode, infos):
        """Fixed-width iterate table of a fused pass; colors unless
        CNRMode; WideConsole adds the factorization columns."""
        GRN, CYN, END = ("\033[92m", "\033[96m", "\033[0m") \
            if not self.CNRMode else ("",) * 3
        cols = ["iter", "objective", "KKT-inf", "ECons-inf", "ICons-inf",
                "barrier", "mu", "alpha"]
        if self.WideConsole:
            cols += ["nfacs", "Hpert"]
        w = [5, 15, 10, 10, 10, 10, 9, 7, 6, 9]
        head = " ".join(f"{c:>{w[i]}}" for i, c in enumerate(cols))
        print(f"{CYN}[{mode}] {head}{END}")
        for i, r in enumerate(infos):
            vals = [r[INFO_FIELDS.index(f)] for f in INFO_FIELDS]
            C = GRN if vals[2] < self.EContol and vals[1] < self.KKTtol \
                else ""
            line = (f"{i:>5d} {vals[0]:>+15.8e} {vals[1]:>10.2e} "
                    f"{vals[2]:>10.2e} {vals[3]:>10.2e} {vals[4]:>10.2e} "
                    f"{vals[5]:>9.1e} {vals[6]:>7.3f}")
            if self.WideConsole:
                line += f" {int(vals[7]):>6d} {vals[8]:>9.1e}"
            print(f"{C}{line}{END if C else ''}")

    # ------------------------------------------------------------- main loop
    def _alg_impl(self, mode, x, s, lamE, lamI):
        nlp = self.nlp
        dev = nlp.device
        n, mE, mI = nlp.numPrimal, nlp.numEq, nlp.numIq
        # OPTNO (a solve-pass mode): objective off, Soe bar/LS knobs,
        # constraint Hessians kept (sigma=0 drops the objective terms)
        soe_like = mode in ("SOE", "OPTNO")
        sigma = 0.0 if soe_like else self.ObjScale
        barmode = self.SoeBarMode if soe_like else self.OptBarMode
        lsmode = self.SoeLSMode if soe_like else self.OptLSMode
        kkt = self.kkt

        Mu = self.initMu
        Hpert0 = self.deltaH
        first_pert = True
        hfacs_hist = []
        infos = []
        flag = ConvergenceFlags.NOTCONVERGED
        empty = torch.zeros((0,), dtype=config.DTYPE, device=dev)

        for it in range(self.MaxIters):
            tf0 = time.perf_counter()
            obj, gradf, cE, cIraw, rd0 = kkt.eval_resid(x, lamE, lamI, sigma)

            if mI > 0:
                s, rI = _slack_reset(s, cIraw, self.NegSlackReset)
                Sig = _sigma_diag(s, lamI, Mu)
                comp = s * lamI
                avgcomp = float(comp.mean())
                mincomp = float(comp.min())
                maxcomp = float(comp.max())
            else:
                rI = cIraw
                Sig = empty
                avgcomp = mincomp = maxcomp = 0.0
            rd = rd0
            self.LastFuncTime += time.perf_counter() - tf0

            # ---------------- factorization with inertia correction ladder
            # Inequalities are condensed: Sigma~ = Sig/(1+gammaI*Sig) folds
            # into the primal block, so the target inertia is mE negatives.
            tq0 = time.perf_counter()
            SigInv = torch.where(Sig > 0, 1.0 / torch.clamp(Sig, min=1e-300),
                                 torch.zeros_like(Sig))
            sig_tilde = Sig / (1.0 + self.gammaI * Sig) if mI > 0 else empty
            target_neigs = mE

            # FastFactorAlg: skip the zero-perturbation probe when recent
            # iterations always needed perturbation.
            zfac = True
            if self.FastFactorAlg and it > 6 and ((it * 3) % 4) != 0:
                cycling = all(hf > 0 for hf in hfacs_hist[-4:])
                zfac = not cycling

            nfacs = 0
            nhpert = 0.0
            factor = None
            if zfac:
                factor, neigs = kkt.factor(x, lamE, lamI, sigma, sig_tilde,
                                           0.0, self.gammaE)
                if neigs > target_neigs:
                    factor = None
            if factor is None:
                p = Hpert0
                incr = self.incrH * (self.incrH if first_pert else 1.0)
                for k in range(self.MaxRefac):
                    factor, neigs = kkt.factor(x, lamE, lamI, sigma,
                                               sig_tilde, p, self.gammaE)
                    nfacs = k + 1
                    nhpert = p
                    if neigs <= target_neigs:
                        break
                    p = p * (incr if k == 0 else self.incrH)
                if nfacs > 0:
                    Hpert0 = max(self.deltaH, nhpert * self.decrH)
                    first_pert = False
            hfacs_hist.append(nfacs)

            # ------------------------------------------- barrier mu update
            corr = 0.0
            if mI > 0:
                if barmode == "PROBE":
                    # Mehrotra probe: affine step (mu = 0 dual gradient)
                    w_aff = rI - SigInv * lamI
                    rx_aff = rd + kkt.iq_rmatvec(factor, sig_tilde * w_aff)
                    dxa, _ = kkt.solve(factor, -rx_aff, -cE)
                    dlamI_aff = sig_tilde * (kkt.iq_matvec(factor, dxa)
                                             + w_aff)
                    ds_aff = -SigInv * (lamI + dlamI_aff)
                    apa = _max_step_to_boundary(s, ds_aff,
                                                self.BoundFraction)
                    ada = _max_step_to_boundary(lamI, dlamI_aff,
                                                self.BoundFraction)
                    navg = float(((s + apa * ds_aff)
                                  * (lamI + ada * dlamI_aff)).mean())
                    Mu = (navg / avgcomp) ** 3 * avgcomp if avgcomp != 0 \
                        else Mu
                    if self.ProbeCorrector:
                        corr = ds_aff * dlamI_aff / s
                else:  # LOQO (reference default)
                    eta = mincomp / avgcomp if avgcomp != 0 else 0.0
                    sigmat = 0.1 * (0.05 * (1.0 - eta)
                                    / max(eta, 1e-300)) ** 3 \
                        if eta > 0 else 0.8
                    sig_mu = min(0.8, abs(sigmat))
                    Mu = sig_mu * avgcomp
                Mu = float(np.clip(Mu, self.MinMu, self.MaxMu))
                BarrObj = float(-Mu * torch.sum(torch.log(s)))
                rs = lamI - Mu / s + corr
            else:
                BarrObj = 0.0
                rs = empty

            # ------------------------------------------------- newton solve
            w = rI - SigInv * rs
            rhs_x = rd + kkt.iq_rmatvec(factor, sig_tilde * w) \
                if mI > 0 else rd
            dx, dlamE = kkt.solve(factor, -rhs_x, -cE)
            if mI > 0:
                dlamI = sig_tilde * (kkt.iq_matvec(factor, dx) + w)
                ds = -SigInv * (rs + dlamI)
            else:
                dlamI = lamI
                ds = s
            good = bool(torch.isfinite(torch.sum(dx ** 2))
                        and torch.isfinite(torch.sum(dlamE ** 2)))
            self.LastKKTTime += time.perf_counter() - tq0

            alphap = alphad = 1.0
            if mI > 0 and good:
                alphap = _max_step_to_boundary(s, ds, self.BoundFraction)
                alphad = _max_step_to_boundary(lamI, dlamI,
                                               self.BoundFraction)
                strat = str(self.PDStepStrategy)
                if strat == "AllMinimum":
                    am = min(alphap, alphad)
                    sp = ss = se = si = am
                elif strat == "PrimSlack_EqIq":
                    sp = ss = alphap
                    se = si = alphad
                elif strat == "MaxEq":
                    sp = ss = alphap
                    se = max(alphap, alphad)
                    si = alphad
                else:  # PrimSlackEq_Iq (reference default)
                    sp = ss = se = alphap
                    si = alphad
                dx = dx * sp
                ds = ds * ss
                dlamE = dlamE * se
                dlamI = dlamI * si

            # -------------------------------------------------- line search
            tf0 = time.perf_counter()
            alpha = 1.0
            if good and lsmode in ("AUGLANG", "L1", "LANG"):
                alpha = self._line_search(
                    lsmode, sigma if mode != "SOE" else 0.0, Mu,
                    float(obj) * sigma, BarrObj,
                    x, s, lamE, lamI, dx, ds, dlamE, dlamI,
                    rd, rs, cE, rI)
            self.LastFuncTime += time.perf_counter() - tf0

            # ----------------------------------------------- iterate record
            kktinf = float(rd.abs().max()) if n else 0.0
            econinf = float(cE.abs().max()) if mE else 0.0
            iconinf = float(rI.abs().max()) if mI else 0.0
            infos.append(dict(iter=it, obj=float(obj), kkt=kktinf,
                              econ=econinf, icon=iconinf, barr=maxcomp,
                              mu=Mu, alpha=alpha, nfacs=nfacs,
                              hpert=nhpert))
            if callable(self.EarlyCallBack):
                self.EarlyCallBack(dict(
                    mode=mode, x=_np(x), dx=_np(dx), lamE=_np(lamE),
                    lamI=_np(lamI), info=infos[-1]))
            if self.PrintLevel == 0:
                print(f"  [{mode}] it {it:3d} obj {float(obj):+.6e} "
                      f"kkt {kktinf:8.2e} econ {econinf:8.2e} "
                      f"icon {iconinf:8.2e} barr {maxcomp:8.2e} "
                      f"mu {Mu:8.2e} a {alpha:5.3f} f {nfacs}")

            flag = self._converge_check(infos)
            if not good:
                flag = ConvergenceFlags.DIVERGING
            if flag in (ConvergenceFlags.CONVERGED,
                        ConvergenceFlags.ACCEPTABLE,
                        ConvergenceFlags.DIVERGING) \
                    or it == self.MaxIters - 1:
                break

            x = x + alpha * dx
            if mI > 0:
                s = s + alpha * ds
                lamI = lamI + alpha * dlamI
            lamE = lamE + alpha * dlamE

        self.LastIterNum += len(infos)
        if self.PrintLevel <= 1:
            i0 = infos[-1]
            print(f"PSIOPT [{mode}] {ConvergenceFlags._names[flag]} in "
                  f"{len(infos)} iters: obj {i0['obj']:+.8e} "
                  f"kkt {i0['kkt']:.2e} econ {i0['econ']:.2e} "
                  f"icon {i0['icon']:.2e} barr {i0['barr']:.2e}")
        if self.storespmat:
            self._store_spmat(x, s, lamE, lamI, Mu, sigma)
        return x, s, lamE, lamI, flag

    # ------------------------------------------------------------ line search
    def _line_search(self, lsmode, sigma, Mu, PrimObj, BarrObj,
                     x, s, lamE, lamI, dx, ds, dlamE, dlamI,
                     rd, rs, cE, rI):
        """Merit line search (AUGLANG: augmented-Lagrangian merit with an
        L1 term on rows still infeasible beyond 10x tolerance)."""
        nlp = self.nlp
        mE, mI = nlp.numEq, nlp.numIq
        allcons = np.concatenate([_np(cE), _np(rI)])
        lm = np.concatenate([_np(lamE), _np(lamI)])
        dlm = np.concatenate([_np(dlamE), _np(dlamI)])

        vv = float(np.concatenate([_np(rd), _np(rs)]) @
                   np.concatenate([_np(dx), _np(ds)]))
        cv = float(dlm @ allcons)
        init_l2 = float(allcons @ allcons)
        init_linf = float(np.max(np.abs(allcons))) if allcons.size else 0.0
        sc = (0.01 if lsmode == "AUGLANG" else 0.1) + \
            abs(vv - cv) / init_l2 if init_l2 > 0 else 1.0

        lang_init = PrimObj + BarrObj
        init_l1 = float(np.abs(lm) @ np.abs(allcons))
        lang_init += init_l1 + init_l2 * sc
        lamE_abs, lamI_abs = np.abs(_np(lamE)), np.abs(_np(lamI))

        alpha = 1.0
        for j in range(self.MaxLSIters):
            x2 = x + alpha * dx
            s2 = s + alpha * ds if mI > 0 else s
            obj2, cE2, cI2raw = nlp.eval_obj_cons(x2)
            ptest = float(obj2) * sigma
            if mI > 0:
                s2r, rI2 = _slack_reset(s2, cI2raw, self.NegSlackReset)
                btest = float(-Mu * torch.sum(torch.log(s2r)))
            else:
                rI2 = cI2raw
                btest = 0.0
            cE2, rI2 = _np(cE2), _np(rI2)
            allcons2 = np.concatenate([cE2, rI2])
            test_l2 = float(allcons2 @ allcons2)
            test_linf = float(np.max(np.abs(allcons2))) \
                if allcons2.size else 0.0

            if lsmode == "AUGLANG":
                eqerr = np.abs(cE2)
                iqerr = np.abs(rI2)
                test_l1 = 0.0
                if mE:
                    m = eqerr > self.EContol * 10
                    test_l1 += float(eqerr[m] @ lamE_abs[m])
                if mI:
                    m = iqerr > self.IContol * 10
                    test_l1 += float(iqerr[m] @ lamI_abs[m])
                l2eff = test_l2
                if test_l2 < (self.EContol ** 2 * mE
                              + self.IContol ** 2 * mI):
                    l2eff = 0.0
                lang_test = ptest + btest + test_l1 + l2eff * sc
            else:  # L1 / LANG simplified to the same descent test
                test_l1 = float(np.abs(lm) @ np.abs(allcons2))
                lang_test = ptest + btest + test_l1 + test_l2 * sc

            if lang_test < lang_init \
                    or (ptest < PrimObj and test_l2 < init_l2) \
                    or (ptest < PrimObj and test_linf < init_linf):
                break
            alpha /= self.alphaRed
        return alpha

    # -------------------------------------------------------- convergence
    def _converge_check(self, infos):
        last = infos[-1]
        vals = (last["kkt"], last["econ"], last["icon"], last["barr"])
        if any(not math.isfinite(v) for v in vals) \
                or last["kkt"] > self.DivKKTtol \
                or last["econ"] > self.DivEContol \
                or last["icon"] > self.DivIContol \
                or last["barr"] > self.DivBartol:
            return ConvergenceFlags.DIVERGING
        if (last["kkt"] < self.KKTtol and last["econ"] < self.EContol
                and last["icon"] < self.IContol
                and last["barr"] < self.Bartol):
            return ConvergenceFlags.CONVERGED
        if len(infos) > self.MaxAccIters:
            ok = all(
                i["kkt"] < self.AccKKTtol and i["econ"] < self.AccEContol
                and i["icon"] < self.AccIContol
                and i["barr"] < self.AccBartol
                for i in infos[-self.MaxAccIters:])
            if ok:
                return ConvergenceFlags.ACCEPTABLE
        return ConvergenceFlags.NOTCONVERGED
