"""The fused PSIOPT loop: the whole IPM algorithm on batched device state.

Port of `asset_asrl_tpu/Solvers/fused.py` (`build_fused_alg`,
`build_fused_ensemble`).  Every piece of one iteration (family AD with
Hessians once, slack reset, barrier update with the Mehrotra probe, the
inertia-correction ladder over pre-assembled blocks, the Newton solve,
fraction-to-boundary, the merit line search, the convergence tiers,
ReturnBest tracking) works on tensors with a leading lane axis: B problems
of one structure (a scenario batch), or B = 1 for a single solve.

There is no `lax.while_loop`, so the JAX loops become:

* the outer loop: a host `while` that reads "any lane still NOTCONVERGED
  and under MaxIters" once per iteration.  A finished lane is frozen with
  `torch.where`, so its state is bitwise what it was when it finished;
  every lane keeps its own iteration counter;
* the factor ladder: every lane has its own delta, next delta and refactor
  count.  The first factorization is forced; then the batch is refactored
  while any active lane has the wrong inertia and refactors left, and only
  the climbing lanes take the new factor (`torch.where` over every factor
  tensor), so a lane's result does not depend on its batch mates;
* the line search: a fixed loop of MaxLSIters masked steps; a lane that
  accepted keeps its alpha.  It reads nothing on the host.

So the host reads one flag per iteration and one per ladder step, the
places where a JAX while_loop reads its condition.  The JAX package's
non-TPU branches are the ones ported: the inertia probe at delta 0, no
zero-target refinement, no ASSET_PROBE0 verification.

Each stage of an iteration runs inside a `Utils.span` (`asset.fused.*`,
a profiler range while a profiler records) that adds its host seconds to
the run's stats: `ad_s` (family AD), `kkt_s` (assembly, factorizations,
solves and the inequality matvecs), `ls_s` (the line search), `read_s`
(the host reads, i.e. waiting on the device).  They do not overlap, so
`loop_s` (the whole run) less their sum is the rest of the loop.
"""

from __future__ import annotations

import time

import torch

from .. import config
from ..Utils import span
from .cuda_kernels import gj_inverse

__all__ = ["build_fused_alg", "build_fused_ensemble", "init_multipliers",
           "INFO_FIELDS"]

INFO_FIELDS = ("obj", "kkt", "econ", "icon", "barr", "mu", "alpha",
               "nfacs", "hpert")

# flags (match psiopt.ConvergenceFlags)
_CONV, _ACC, _NOTCONV, _DIV = 0, 1, 2, 3

# profiler ranges (`Utils.span`)
_ITERATION = "asset.fused.iteration"
_FAMILY_AD = "asset.fused.family_ad"
_ASSEMBLY = "asset.fused.assembly"
_FACTOR = "asset.fused.factor"
_SOLVE = "asset.fused.solve"
_LINE_SEARCH = "asset.fused.line_search"
_READ = "asset.fused.read"
# the run's counters (`fn.stats`), reset at each call: counts, and host
# seconds by stage
_COUNTS = ("iterations", "syncs", "factorizations", "k1_launches",
           "ad_replays", "ad_eager")
_STAGES = ("ad_s", "kkt_s", "ls_s", "read_s", "loop_s")


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


def _maxstep(v, dv, bfrac):
    """Per lane: the largest alpha <= 1 with v + alpha*dv >= (1-bfrac)*v."""
    if v.shape[-1] == 0:
        return v.new_ones(v.shape[:-1])
    bad = dv < -bfrac * v
    cand = torch.where(bad, -bfrac * v / torch.where(bad, dv, -1.0), 1.0)
    return cand.amin(-1).clamp(max=1.0)


def _amax(v):
    """Per lane: max |v| over the last axis (0 when it is empty)."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(-1)


def _bcast(c, a):
    """A lane mask c (B,) shaped to broadcast against a (B, ...)."""
    return c.view((-1,) + (1,) * (a.dim() - 1))


def _select(c, new, old):
    """Per lane: new where c, else old, over nested dicts / lists."""
    if isinstance(new, dict):
        return {k: _select(c, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(_select(c, a, b) for a, b in zip(new, old))
    if new is None:
        return None
    return torch.where(_bcast(c, new), new, old)


def init_multipliers(kkt, x, sigma, gammaE, consts, stats=None):
    """Least-squares equality multipliers of every lane (x (B, n)): one
    first-order factorization (structural-zero Hessians, unit primal
    diagonal, unit slack Hessian); the equality block of -K^{-1} [sigma
    gradf; 0].  Returns (B, mE), not checked for finiteness.  With
    `stats`, the stages' host seconds are added to its `ad_s` / `kkt_s`."""
    nlp = kkt.nlp
    B, dev = x.shape[0], x.device
    zE = torch.zeros((B, nlp.numEq), dtype=config.DTYPE, device=dev)
    zI = torch.zeros((B, nlp.numIq), dtype=config.DTYPE, device=dev)
    with span(_FAMILY_AD, stats, "ad_s"):
        _, _, _, rd0, fam0 = kkt._eval_core(x, zE, zI, float(sigma), consts,
                                            want_hess="zeros")
    with span(_ASSEMBLY, stats, "kkt_s"):
        blocks0 = kkt._blocks_impl(fam0, torch.ones_like(zI))
    with span(_FACTOR, stats, "kkt_s"):
        fac0, _ = kkt._factor_blocks_impl(blocks0, 1.0, float(gammaE))
    with span(_SOLVE, stats, "kkt_s"):
        _, lamE0 = kkt._solve_impl(fac0, -rd0, zE)
    return lamE0


def build_fused_alg(kkt, opts, mode):
    """Build the whole-solve function for one mode ('OPT', 'OPTNO' or
    'SOE').

    opts: snapshot of PSIOPT knobs (plain python floats/ints/strings).
    Returns fn(x, s, lamE, lamI, Mu0, consts) -> (x, s, lamE, lamI, Mu,
    flag, niters, infos, best_x, best_s, best_lamE, best_lamI).  The state
    has a leading lane axis (x (B, n), ...; flag, niters, Mu (B,); infos
    (B, MaxIters, 9)); one problem is B = 1.  fn.stats holds the last
    call's outer iterations, host reads ("syncs"), factorizations, K1
    launches ("k1_launches"), family-AD passes replayed from a CUDA graph
    ("ad_replays") and run eagerly ("ad_eager"), and the host seconds of
    its stages (module docstring)."""
    nlp = kkt.nlp
    mE, mI = nlp.numEq, nlp.numIq
    soe = mode in ("SOE", "OPTNO")
    sigma = 0.0 if soe else float(opts["ObjScale"])
    want_hess = "zeros" if mode == "SOE" else True
    unit_diag = 1.0 if mode == "SOE" else 0.0
    zero_rd = mode == "SOE"
    barmode = opts["SoeBarMode"] if soe else opts["OptBarMode"]
    lsmode = opts["SoeLSMode"] if soe else opts["OptLSMode"]
    pdstrat = str(opts.get("PDStepStrategy", "PrimSlackEq_Iq"))
    init_lmults = bool(opts.get("InitLmults", False))
    probe_corr = bool(opts.get("ProbeCorrector", True))
    MaxIters = int(opts["MaxIters"])
    MaxAccIters = int(opts["MaxAccIters"])
    MaxLSIters = int(opts["MaxLSIters"])
    MaxRefac = int(opts["MaxRefac"])
    KKTtol, ECtol, ICtol, Btol = (float(opts["KKTtol"]),
                                  float(opts["EContol"]),
                                  float(opts["IContol"]),
                                  float(opts["Bartol"]))
    AccK, AccE, AccI, AccB = (float(opts["AccKKTtol"]),
                              float(opts["AccEContol"]),
                              float(opts["AccIContol"]),
                              float(opts["AccBartol"]))
    DivK, DivE, DivI, DivB = (float(opts["DivKKTtol"]),
                              float(opts["DivEContol"]),
                              float(opts["DivIContol"]),
                              float(opts["DivBartol"]))
    bfrac = float(opts["BoundFraction"])
    negreset = float(opts["NegSlackReset"])
    deltaH = float(opts["deltaH"])
    incrH = float(opts["incrH"])
    decrH = float(opts["decrH"])
    MinMu, MaxMu = float(opts["MinMu"]), float(opts["MaxMu"])
    gammaE = float(opts["gammaE"])
    gammaI = float(opts["gammaI"])
    alphaRed = float(opts["alphaRed"])
    FastFactor = bool(opts["FastFactorAlg"])
    best_mode = str(opts.get("BestCriteria", "ECons"))
    eval_oc = nlp.eval_obj_cons_impl
    stats = {}

    def reset_stats():
        stats.update(dict.fromkeys(_COUNTS, 0))
        stats.update(dict.fromkeys(_STAGES, 0.0))
    reset_stats()

    def factor_blocks(blocks, d):
        # unit_diag: SOE mode's unit primal diagonal
        stats["factorizations"] += 1
        with span(_FACTOR, stats, "kkt_s"):
            return kkt._factor_blocks_impl(blocks, d + unit_diag, gammaE)

    def read(flags):
        """Whether any entry of the device tensor `flags` is set: one host
        read."""
        stats["syncs"] += 1
        with span(_READ, stats, "read_s"):
            return bool(flags.any())

    def factor_ladder(blocks, Hpert0, first_pert, zfac, active):
        """Inertia-correction ladder: probe at delta = 0 when allowed,
        then climb the deltas until the inertia is right, lane by lane."""
        d0 = torch.where(zfac, 0.0, Hpert0)
        incr0 = incrH * torch.where(first_pert, incrH, 1.0)
        dnext = torch.where(zfac, Hpert0, Hpert0 * incr0)
        fac, neigs = factor_blocks(blocks, d0)
        dused = d0
        k = torch.zeros_like(neigs)
        while True:
            climbing = (neigs > mE) & (k < MaxRefac) & active
            if not read(climbing):
                return fac, neigs, dused, k
            fac2, neigs2 = factor_blocks(blocks, dnext)
            fac = _select(climbing, fac2, fac)
            neigs = torch.where(climbing, neigs2, neigs)
            dused = torch.where(climbing, dnext, dused)
            dnext = torch.where(climbing, dnext * incrH, dnext)
            k = torch.where(climbing, k + 1, k)

    def line_search(x, s, lamE, lamI, dx, ds, PrimObj, BarrObj, Mu,
                    rd, rs, cE, rI, lamE_d, lamI_d, consts):
        """Merit line search, MaxLSIters masked trials for every lane."""
        allcons = torch.cat([cE, rI], 1)
        lm = torch.cat([lamE, lamI], 1).abs()
        vv = (torch.cat([rd, rs], 1) * torch.cat([dx, ds], 1)).sum(-1)
        cv = (torch.cat([lamE_d, lamI_d], 1) * allcons).sum(-1)
        init_l2 = (allcons * allcons).sum(-1)
        init_linf = _amax(allcons)
        sc0 = 0.01 if lsmode == "AUGLANG" else 0.1
        sc = torch.where(init_l2 > 0, sc0 + (vv - cv).abs() / init_l2, 1.0)
        init_l1 = (lm * allcons.abs()).sum(-1)
        lang_init = PrimObj + BarrObj + init_l1 + init_l2 * sc

        def merit(alpha):
            x2 = x + alpha[:, None] * dx
            obj2, cE2, cI2 = eval_oc(x2, consts)
            ptest = obj2 * sigma
            if mI > 0:
                s2r, rI2 = _slack_reset(s + alpha[:, None] * ds, cI2,
                                        negreset)
                btest = -Mu * torch.log(s2r).sum(-1)
            else:
                rI2 = cI2
                btest = 0.0
            allcons2 = torch.cat([cE2, rI2], 1)
            test_l2 = (allcons2 * allcons2).sum(-1)
            test_linf = _amax(allcons2)
            if lsmode == "AUGLANG":
                eqerr, iqerr = cE2.abs(), rI2.abs()
                test_l1 = torch.where(eqerr > ECtol * 10,
                                      eqerr * lamE.abs(), 0.0).sum(-1) \
                    + torch.where(iqerr > ICtol * 10,
                                  iqerr * lamI.abs(), 0.0).sum(-1)
                l2eff = torch.where(
                    test_l2 < (ECtol ** 2 * mE + ICtol ** 2 * mI),
                    0.0, test_l2)
                lang_test = ptest + btest + test_l1 + l2eff * sc
            else:
                test_l1 = (lm * allcons2.abs()).sum(-1)
                lang_test = ptest + btest + test_l1 + test_l2 * sc
            return (lang_test < lang_init) \
                | ((ptest < PrimObj) & (test_l2 < init_l2)) \
                | ((ptest < PrimObj) & (test_linf < init_linf))

        alpha = torch.ones_like(PrimObj)
        done = torch.zeros_like(PrimObj, dtype=torch.bool)
        for _ in range(MaxLSIters):
            ok = merit(alpha)
            alpha = torch.where(done | ok, alpha, alpha / alphaRed)
            done = done | ok
        return alpha

    def iteration(st, consts):
        it, x, s, lamE, lamI = st["it"], st["x"], st["s"], st["lamE"], \
            st["lamI"]
        Mu, Hpert0 = st["Mu"], st["Hpert0"]
        # Lane freezing: every lane runs the iteration, and `active` gates
        # the state update below, so a finished lane's state is bitwise
        # what it was when it finished (its per-problem solve).
        active = (st["flag"] == _NOTCONV) & (it < MaxIters)
        B = x.shape[0]
        zB = x.new_zeros((B,))

        with span(_FAMILY_AD, stats, "ad_s"):
            obj, cE, cIraw, rd, famvals = kkt._eval_core(
                x, lamE, lamI, sigma, consts, want_hess=want_hess)
        if zero_rd:
            # first-order feasibility steps: zero primal gradient
            rd = torch.zeros_like(rd)

        if mI > 0:
            s, rI = _slack_reset(s, cIraw, negreset)
            Sig = _sigma_diag(s, lamI, Mu[:, None])
            SigInv = torch.where(Sig > 0, 1.0 / torch.clamp(Sig, min=1e-300),
                                 0.0)
            sig_tilde = Sig / (1.0 + gammaI * Sig)
            comp = s * lamI
            avgcomp = comp.mean(-1)
            mincomp = comp.amin(-1)
            maxcomp = comp.amax(-1)
        else:
            rI = cIraw
            sig_tilde = SigInv = x.new_zeros((B, 0))
            avgcomp = mincomp = maxcomp = zB

        with span(_ASSEMBLY, stats, "kkt_s"):
            blocks = kkt._blocks_impl(famvals, sig_tilde)

        # FastFactorAlg probe heuristic: skip the delta=0 probe when the
        # last 4 iterations all needed perturbation.
        cycling = st["nonzero4"].all(-1)
        zfac = ~(FastFactor & (it > 6) & (((it * 3) % 4) != 0) & cycling)
        fac, neigs, dused, nfacs = factor_ladder(
            blocks, Hpert0, st["first_pert"], zfac, active)
        fac["iq_jx"] = famvals["jx_iq"]
        pert_used = dused > 0
        Hpert0 = torch.where(pert_used,
                             torch.clamp(dused * decrH, min=deltaH), Hpert0)
        first_pert = st["first_pert"] & ~pert_used
        nonzero4 = torch.cat([st["nonzero4"][:, 1:], pert_used[:, None]], 1)

        # ------------------------------------------- barrier mu update
        corr = 0.0
        if mI > 0:
            if barmode == "PROBE":
                w_aff = rI - SigInv * lamI
                with span(_SOLVE, stats, "kkt_s"):
                    rx_aff = rd + kkt._iq_rmatvec_impl(fac,
                                                       sig_tilde * w_aff)
                    dxa, _ = kkt._solve_impl(fac, -rx_aff, -cE)
                    dlamI_aff = sig_tilde * (kkt._iq_matvec_impl(fac, dxa)
                                             + w_aff)
                ds_aff = -SigInv * (lamI + dlamI_aff)
                # fraction-to-boundary damping of the affine probe
                apa = _maxstep(s, ds_aff, bfrac)
                ada = _maxstep(lamI, dlamI_aff, bfrac)
                navg = ((s + apa[:, None] * ds_aff)
                        * (lamI + ada[:, None] * dlamI_aff)).mean(-1)
                Mu = torch.where(avgcomp != 0,
                                 (navg / avgcomp) ** 3 * avgcomp, Mu)
                if probe_corr:
                    # Mehrotra second-order correction
                    corr = ds_aff * dlamI_aff / s
            else:  # LOQO
                eta = torch.where(avgcomp != 0, mincomp / avgcomp, 0.0)
                sigmat = 0.1 * (0.05 * (1.0 - eta)
                                / torch.clamp(eta, min=1e-300)) ** 3
                sig_mu = torch.where(eta > 0,
                                     torch.clamp(sigmat.abs(), max=0.8), 0.8)
                Mu = sig_mu * avgcomp
            Mu = torch.clamp(Mu, MinMu, MaxMu)
            BarrObj = -Mu * torch.log(torch.clamp(s, min=1e-300)).sum(-1)
            rs = lamI - Mu[:, None] / s + corr
        else:
            BarrObj = zB
            rs = x.new_zeros((B, 0))

        # ---------------------------------------------------- newton solve
        with span(_SOLVE, stats, "kkt_s"):
            if mI > 0:
                w = rI - SigInv * rs
                rhs_x = rd + kkt._iq_rmatvec_impl(fac, sig_tilde * w)
            else:
                rhs_x = rd
            dx, dlamE = kkt._solve_impl(fac, -rhs_x, -cE)
            if mI > 0:
                dlamI = sig_tilde * (kkt._iq_matvec_impl(fac, dx) + w)
                ds = -SigInv * (rs + dlamI)
            else:
                dlamI, ds = lamI, s
        good = torch.isfinite((dx ** 2).sum(-1)) \
            & torch.isfinite((dlamE ** 2).sum(-1))

        if mI > 0:
            alphap = _maxstep(s, ds, bfrac)
            alphad = _maxstep(lamI, dlamI, bfrac)
            if pdstrat == "AllMinimum":
                am = torch.minimum(alphap, alphad)
                steps = (am, am, am, am)
            elif pdstrat == "PrimSlack_EqIq":
                steps = (alphap, alphap, alphad, alphad)
            elif pdstrat == "MaxEq":
                steps = (alphap, alphap, torch.maximum(alphap, alphad),
                         alphad)
            else:  # PrimSlackEq_Iq (reference default)
                steps = (alphap, alphap, alphap, alphad)
            dx = dx * steps[0][:, None]
            ds = ds * steps[1][:, None]
            dlamE = dlamE * steps[2][:, None]
            dlamI = dlamI * steps[3][:, None]

        # ------------------------------------------------------ line search
        if lsmode in ("AUGLANG", "L1", "LANG"):
            with span(_LINE_SEARCH, stats, "ls_s"):
                alpha = line_search(x, s, lamE, lamI, dx, ds, obj * sigma,
                                    BarrObj, Mu, rd, rs, cE, rI, dlamE,
                                    dlamI, consts)
            alpha = torch.where(good, alpha, 1.0)
        else:
            alpha = x.new_ones((B,))

        # -------------------------------------------------- iterate record
        kktinf, econinf, iconinf = _amax(rd), _amax(cE), _amax(rI)
        barrinf = maxcomp
        info = torch.stack([obj, kktinf, econinf, iconinf, barrinf, Mu,
                            alpha, nfacs.to(config.DTYPE), dused], -1)
        lanes = torch.arange(B, device=x.device)
        row = it.clamp(max=MaxIters - 1)
        infos = st["infos"]
        infos[lanes, row] = torch.where(active[:, None], info,
                                        infos[lanes, row])

        # ---------------------------------------------- convergence ladder
        diverging = (~good) \
            | ~torch.isfinite(kktinf + econinf + iconinf + barrinf) \
            | (kktinf > DivK) | (econinf > DivE) | (iconinf > DivI) \
            | (barrinf > DivB)
        converged = (kktinf < KKTtol) & (econinf < ECtol) \
            & (iconinf < ICtol) & (barrinf < Btol)
        accrow = (kktinf < AccK) & (econinf < AccE) \
            & (iconinf < AccI) & (barrinf < AccB)
        acc_count = torch.where(accrow, st["acc_count"] + 1, 0)
        acceptable = acc_count > MaxAccIters
        flag = torch.where(diverging, _DIV, torch.where(
            converged, _CONV, torch.where(acceptable, _ACC, _NOTCONV)))

        # --------------------------------------------- ReturnBest tracking
        if best_mode == "ObjVal":
            crit = obj
        elif best_mode == "KKT":
            crit = kktinf
        else:  # ECons (reference default)
            crit = torch.maximum(econinf, iconinf)
        better = crit < st["best_crit"]
        new = dict(best_crit=torch.where(better, crit, st["best_crit"]),
                   best_x=_select(better, x, st["best_x"]),
                   best_s=_select(better, s, st["best_s"]),
                   best_lE=_select(better, lamE, st["best_lE"]),
                   best_lI=_select(better, lamI, st["best_lI"]))

        # ------------------------------------------------------ take step
        stepa = torch.where((flag == _NOTCONV) & good, alpha, 0.0)[:, None]
        x = x + stepa * dx
        lamE = lamE + stepa * dlamE
        if mI > 0:
            s = s + stepa * ds
            lamI = lamI + stepa * dlamI
        new.update(it=it + 1, x=x, s=s, lamE=lamE, lamI=lamI, Mu=Mu,
                   Hpert0=Hpert0, first_pert=first_pert, nonzero4=nonzero4,
                   flag=flag, acc_count=acc_count)
        out = {k: _select(active, v, st[k]) for k, v in new.items()}
        out["infos"] = infos
        return out

    def make_init(x, s, lamE, lamI, Mu0, consts):
        B, dev = x.shape[0], x.device
        if init_lmults and mE > 0:
            stats["factorizations"] += 1
            lamE0 = init_multipliers(kkt, x, opts["ObjScale"], gammaE,
                                     consts, stats)
            good = torch.isfinite((lamE0 ** 2).sum(-1))
            lamE = torch.where(good[:, None], lamE0, torch.zeros_like(lamE0))
        i64 = dict(dtype=torch.int64, device=dev)
        full = dict(dtype=config.DTYPE, device=dev)
        return dict(it=torch.zeros((B,), **i64), x=x, s=s, lamE=lamE,
                    lamI=lamI, Mu=torch.full((B,), float(Mu0), **full),
                    Hpert0=torch.full((B,), deltaH, **full),
                    first_pert=torch.ones((B,), dtype=torch.bool,
                                          device=dev),
                    nonzero4=torch.zeros((B, 4), dtype=torch.bool,
                                         device=dev),
                    infos=torch.zeros((B, MaxIters, len(INFO_FIELDS)),
                                      **full),
                    flag=torch.full((B,), _NOTCONV, **i64),
                    acc_count=torch.zeros((B,), **i64),
                    best_crit=torch.full((B,), float("inf"), **full),
                    best_x=x, best_s=s, best_lE=lamE, best_lI=lamI)

    def run(x, s, lamE, lamI, Mu0, consts):
        t0 = time.perf_counter()
        k1_0 = sum(gj_inverse.shapes.values())
        ad0 = dict(kkt.ad_counts)
        reset_stats()
        st = make_init(x, s, lamE, lamI, Mu0, consts)
        while read((st["flag"] == _NOTCONV) & (st["it"] < MaxIters)):
            with span(_ITERATION):
                st = iteration(st, consts)
            stats["iterations"] += 1
        stats["k1_launches"] = sum(gj_inverse.shapes.values()) - k1_0
        for k in ("ad_replays", "ad_eager"):
            stats[k] = kkt.ad_counts[k] - ad0[k]
        stats["loop_s"] = time.perf_counter() - t0
        return (st["x"], st["s"], st["lamE"], st["lamI"], st["Mu"],
                st["flag"], st["it"], st["infos"], st["best_x"],
                st["best_s"], st["best_lE"], st["best_lI"])

    run.stats = stats
    return run


def build_fused_ensemble(kkt, opts, mode, mesh=None, axis="scenario"):
    """The fused solve over a scenario batch: every lane runs the complete
    PSIOPT algorithm (ladder, barrier update, line search, convergence
    tiers) and equals its own `phase.optimize()`; mu0 and consts are
    shared.  Returns fn(xB, sB, lamEB, lamIB, mu0, consts) as
    `build_fused_alg` does.  With a `distributed.Mesh`, the scenario axis
    is split over the mesh's `axis` (`Mesh.lanes`): each rank solves its
    lanes, and every output is gathered, so every rank returns the whole
    batch."""
    run = build_fused_alg(kkt, opts, mode)
    if mesh is None:
        return run

    def sharded(xB, sB, lamEB, lamIB, mu0, consts):
        mine = mesh.lanes(xB.shape[0], axis)
        out = run(xB[mine], sB[mine], lamEB[mine], lamIB[mine], mu0,
                  consts)
        return tuple(mesh.all_gather(o, axis) for o in out)

    sharded.stats = run.stats
    return sharded
