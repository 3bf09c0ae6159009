"""PSIOPT: primal-dual interior-point NLP solver, host-driven loop.

Port of `asset_asrl_tpu/Solvers/psiopt.py` (`_alg_impl`, the host loop):
slacks per inequality, LOQO / PROBE barrier updates, fraction-to-boundary,
merit line search, slack reset, the inertia-corrected factorization ladder
(deltaH/incrH/decrH) and the convergence tiers (CONVERGED / ACCEPTABLE /
NOTCONVERGED / DIVERGING).

The KKT system is reduced by analytic slack elimination to the symmetric
quasi-definite form [[H+dI, JE^T, JI^T], [JE, -gI, 0], [JI, 0, -(1/Sig+g)]]
and factored by the block-tridiagonal backend (`kkt_block.BlockKKT`).  The
per-iteration math runs on the problem's device; the loop, the ladder and
the line search decisions run on the host, reading a few scalars per
iteration.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import config
from .nlp import NonLinearProgram

__all__ = ["PSIOPT", "ConvergenceFlags"]


class ConvergenceFlags:
    CONVERGED = 0
    ACCEPTABLE = 1
    NOTCONVERGED = 2
    DIVERGING = 3

    _names = {0: "CONVERGED", 1: "ACCEPTABLE", 2: "NOTCONVERGED",
              3: "DIVERGING"}


def _slack_reset(s, cI, negreset):
    """When the raw inequality value is feasible (<0), zero its residual
    and snap the slack to |c|; otherwise residual = c + s."""
    s = torch.clamp(s, min=negreset)
    feas = cI < 0.0
    rI = torch.where(feas, torch.zeros_like(cI), cI + s)
    s = torch.where(feas, torch.clamp(cI.abs(), min=negreset), s)
    return s, rI


def _sigma_diag(s, lamI, mu):
    """Primal-dual barrier diagonal lam/s with primal fallback mu/s^2."""
    hp = lamI / s
    return torch.where(hp < 0.0, mu / (s * s), hp)


def _max_step_to_boundary(v, dv, bfrac):
    """max alpha with v + alpha*dv >= (1-bfrac)*v."""
    bad = dv < -bfrac * v
    cand = torch.where(bad, -bfrac * v / torch.where(bad, dv, -1.0),
                       torch.ones_like(v))
    if cand.numel() == 0:
        return 1.0
    return min(1.0, float(cand.min()))


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
        self.PrintLevel = 0
        self.FastFactorAlg = True
        self.gammaE = 1.0e-10   # dual regularization (quasi-definiteness)
        self.gammaI = 1.0e-10

        # --- outputs ---
        self.LastObjVal = 0.0
        self.LastIterNum = 0
        self.LastTotalTime = 0.0
        self.LastFuncTime = 0.0
        self.LastKKTTime = 0.0
        self.ConvergeFlag = ConvergenceFlags.NOTCONVERGED
        self.LastEqLmults = None
        self.LastIqLmults = None
        self.LastSlacks = None

        self.nlp = nlp
        self.kkt = kkt

    def set_PrintLevel(self, p):
        self.PrintLevel = int(p)

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
    def solve(self, x):
        """Feasibility pass (SoeMode)."""
        return self._run(x, ["SOE"])

    def optimize(self, x):
        return self._run(x, ["OPT"])

    # ------------------------------------------------------------------- run
    def _run(self, x0, schedule):
        self.nlp.freeze()
        if self.kkt is None:
            raise NotImplementedError(
                "PSIOPT needs a block KKT backend; the dense KKT backend is "
                "not ported yet (ROADMAP queue 1, item 6)")
        t0 = time.perf_counter()
        self.LastIterNum = 0
        self.LastFuncTime = 0.0
        self.LastKKTTime = 0.0
        x, s, lamE, lamI = self._init_state(np.asarray(x0, np.float64),
                                            self.initMu)
        flag = ConvergenceFlags.NOTCONVERGED
        for mode in schedule:
            if mode == "SOE":
                mode = str(self.SoeMode)
            x, s, lamE, lamI, flag = self._alg_impl(mode, x, s, lamE, lamI)
            if flag == ConvergenceFlags.DIVERGING:
                break
        self.ConvergeFlag = flag
        self.LastEqLmults = _np(lamE)
        self.LastIqLmults = _np(lamI)
        self.LastSlacks = _np(s)
        obj, _, _ = self.nlp.eval_obj_cons(x)
        self.LastObjVal = float(obj)
        self.LastTotalTime = time.perf_counter() - t0
        return _np(x)

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
