"""Scenario-batch execution: B problems of one structure on one device.

Port of `asset_asrl_tpu/parallel.py`.  A transcribed phase's whole IPM
iteration works on state with a leading lane axis, so a batch of scenarios
(perturbed initial states, or whole solver inputs) runs as one program:
every family AD pass, every K1 launch of a block-cyclic-reduction level and
every solve sweep carries all B lanes.

`make_iteration_step(phase)` builds the simplified always-full-step LOQO
iteration (slack reset, barrier update, condensed block-KKT factor + solve,
fraction-to-boundary, no merit retries); `make_batched_step` is the same
function over a batch.  `solve_ensemble` runs the complete fused PSIOPT
algorithm (`Solvers/fused.py`) in every lane, each equal to its own
`phase.optimize()`.  With a `distributed.Mesh`, both split the scenario
axis over the mesh's `axis`: each rank runs its lanes (`Mesh.lanes`) and
the results are gathered, so every rank returns the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .Utils import span
from .Solvers.fused import _maxstep, _sigma_diag, _slack_reset, \
    build_fused_ensemble

__all__ = ["make_iteration_step", "init_state", "make_batched_step",
           "solve_ensemble"]


def _block_kkt(phase):
    if phase._need_transcribe or phase._nlp is None:
        phase.transcribe()
    from .Solvers.psiopt import BLOCK_BACKENDS
    kkt = phase.optimizer.kkt
    if not isinstance(kkt, BLOCK_BACKENDS):
        raise ValueError("a batched solve needs the block KKT backend")
    return kkt


def _lane_step(phase, delta=1.0e-5, gammaE=1.0e-10, gammaI=1.0e-10,
               boundfrac=0.99):
    """One full primal-dual IPM iteration of every lane as a pure function.

    state = (x, s, lamE, lamI, mu), each with a leading lane axis (mu
    (B,)); returns the updated state and the (kkt, econ, icon, barr)
    infeasibilities of each lane (B, 4)."""
    kkt = _block_kkt(phase)
    nlp = phase._nlp
    mE, mI = nlp.numEq, nlp.numIq

    def step(state):
        x, s, lamE, lamI, mu = state
        consts = nlp.consts_dev()
        _, _, cE, cIraw, rd = kkt._resid_impl(x, lamE, lamI, 1.0, consts)
        s, rI = _slack_reset(s, cIraw, 1e-12)
        Sig = _sigma_diag(s, lamI, mu[:, None])
        SigInv = torch.where(Sig > 0, 1.0 / torch.clamp(Sig, min=1e-300),
                             0.0)
        sig_tilde = Sig / (1.0 + gammaI * Sig)

        comp = s * lamI
        avgcomp = comp.mean(-1)
        eta = comp.amin(-1) / avgcomp
        sigmat = 0.1 * (0.05 * (1.0 - eta) / torch.clamp(eta, min=1e-300)) \
            ** 3
        mu_new = torch.clamp(torch.clamp(sigmat.abs(), max=0.8) * avgcomp,
                             1e-12, 100.0)
        rs = lamI - mu_new[:, None] / s

        fac, _ = kkt._factor_impl(x, lamE, lamI, 1.0, sig_tilde, delta,
                                  gammaE, consts)
        w = rI - SigInv * rs
        rhs_x = rd + kkt._iq_rmatvec_impl(fac, sig_tilde * w)
        dx, dlamE = kkt._solve_impl(fac, -rhs_x, -cE)
        dlamI = sig_tilde * (kkt._iq_matvec_impl(fac, dx) + w)
        ds = -SigInv * (rs + dlamI)

        ap = _maxstep(s, ds, boundfrac)[:, None]
        ad = _maxstep(lamI, dlamI, boundfrac)[:, None]
        x = x + ap * dx
        s = s + ap * ds
        lamE = lamE + ap * dlamE
        lamI = lamI + ad * dlamI

        zero = torch.zeros_like(avgcomp)
        info = torch.stack([rd.abs().amax(-1),
                            cE.abs().amax(-1) if mE else zero,
                            rI.abs().amax(-1) if mI else zero,
                            comp.amax(-1) if mI else zero], -1)
        return (x, s, lamE, lamI, mu_new), info

    return step


def make_iteration_step(phase, delta=1.0e-5, gammaE=1.0e-10,
                        gammaI=1.0e-10, boundfrac=0.99):
    """One full primal-dual IPM iteration of one problem as a pure
    function: state = (x, s, lamE, lamI, mu) -> (state, (kkt, econ, icon,
    barr)), the batched step at B = 1."""
    bstep = _lane_step(phase, delta, gammaE, gammaI, boundfrac)

    def step(state):
        out, info = bstep(tuple(v[None] for v in state))
        return tuple(v[0] for v in out), info[0]

    return step


def init_state(phase, mu0=1.0e-3, boundpush=1.0e-3):
    """Solver state (x, s, lamE, lamI, mu) from the phase's current
    trajectory: slacks from the constraint values with a `boundpush`
    floor, inequality multipliers mu0/s, equality multipliers 0."""
    if phase._need_transcribe or phase._nlp is None:
        phase.transcribe()
    nlp = phase._nlp
    x0 = config.tensor(phase.makeSolverInput(), nlp.device)
    _, _, cI = nlp.eval_obj_cons(x0)
    s = torch.where(cI < -boundpush, cI.abs(),
                    torch.full_like(cI, boundpush))
    return (x0, s, torch.zeros((nlp.numEq,), dtype=config.DTYPE,
                               device=nlp.device),
            mu0 / s, config.tensor(mu0, nlp.device))


def make_batched_step(phase, mesh=None, axis="scenario"):
    """The iteration step over a leading scenario axis: state (x (B, n),
    ..., mu (B,)).  With a mesh, each rank steps its lanes of the whole
    state and the new state and infeasibilities are gathered."""
    step = _lane_step(phase)
    if mesh is None:
        return step

    def sharded(state):
        mine = mesh.lanes(state[0].shape[0], axis)
        out, info = step(tuple(v[mine] for v in state))
        return (tuple(mesh.all_gather(v, axis) for v in out),
                mesh.all_gather(info, axis))
    return sharded


def solve_ensemble(phase, perturb_states=None, mesh=None, mode="OPT",
                   x0s=None):
    """B scenarios sharing the phase's structure, each run through the
    complete fused PSIOPT algorithm in one batched program; every lane
    equals its own `phase.optimizer.optimize(x0)`.  mesh: a
    `distributed.Mesh` to split the scenarios over (B divisible by the
    size of its `axis` "scenario"); every rank returns the whole batch.

    perturb_states: B perturbation vectors of the solver input, OR x0s: B
    full solver inputs.  Returns a dict of numpy arrays: "x" (B, n),
    "flags" (B,), "iters" (B,), "objs" (B,), "infos" (B, MaxIters, 9),
    "lamE", "lamI", "s".  The last call's outer iterations, host reads and
    factorizations are in `phase.optimizer.LastFusedStats`."""
    kkt = _block_kkt(phase)
    opt = phase.optimizer
    nlp = phase._nlp
    dev = nlp.device
    fn = build_fused_ensemble(kkt, opt._opts_snapshot(), mode, mesh=mesh)

    with span("asset.ensemble.start"):
        if x0s is None:
            base = np.asarray(phase.makeSolverInput())
            x0s = np.stack([base + np.asarray(p) for p in perturb_states])
        else:
            x0s = np.stack([np.asarray(x) for x in x0s])
        xB = config.tensor(x0s, dev)
        B = xB.shape[0]

        # per-scenario slacks and multipliers, as PSIOPT's start of a solve
        consts = nlp.consts_dev()
        mu0 = float(opt.initMu)
        _, _, cI = nlp.eval_obj_cons_impl(xB, consts)
        sB = torch.where(cI < -opt.BoundPush, cI.abs(),
                         torch.full_like(cI, opt.BoundPush))
        # a true division, as PSIOPT's start (a number over a tensor is a
        # reciprocal and a product in torch, one rounding more)
        lamIB = torch.full_like(sB, mu0) / sB
        lamEB = torch.zeros((B, nlp.numEq), dtype=config.DTYPE, device=dev)

    x, s, lamE, lamI, _, flag, niters, infos = fn(
        xB, sB, lamEB, lamIB, mu0, consts)[:8]
    opt.LastFusedStats = dict(fn.stats)

    def np_(t):
        return t.detach().cpu().numpy()
    with span("asset.ensemble.results"):
        objs, _, _ = nlp.eval_obj_cons_impl(x, consts)
        return dict(x=np_(x), flags=np_(flag), iters=np_(niters),
                    objs=np_(objs), infos=np_(infos), lamE=np_(lamE),
                    lamI=np_(lamI), s=np_(s))
