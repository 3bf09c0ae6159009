"""Adaptive mesh refinement.

Port of `asset_asrl_tpu/OptimalControl/mesh.py`.  Estimators:

* "integrator": re-integrate each segment with the adaptive DOPRI54
  stepper and compare endpoints, all segments in one batched
  `Integrator.integrate_parallel`.  A failing integrator raises: there is
  no quiet switch to another estimator.
* "deboor" / "polynomial": de Boor's derivative-jump estimator on the
  solved Hermite interpolant.
* "residual": the collocation residual |p'(tau) - h f(p(tau))| of the
  solved Hermite interpolant at off-collocation test points.

update_mesh: new segment count from the error^(1/(order+1)) law clamped by
MeshRedFactor / MeshIncFactor / Min / MaxSegments, with
error-equidistributed bins.  The ODE right-hand sides are evaluated in
batched calls on `config.DEVICE`; the bookkeeping is numpy.
"""

from __future__ import annotations

import math

import numpy as np
from torch.func import vmap

from .. import config
from .interp_table import segment_hermite
from .lgl import lagrange_weights

_TEST_TAUS = np.array([0.3, 0.7])


# Hermite coefficients of every solved segment in one pass: (coef (S, deg+1,
# XV), hs (S,), fs_all (N, XV)); the node tangents come from one batched RHS
# evaluation over all N nodes.  Shared with the trajectory table.
_segment_coefs = segment_hermite


def _residual_errors(phase):
    """Per-segment defect-residual error estimate |p'(sig) - h f(p(sig))|
    at off-collocation test points: one batched RHS call over all
    (segment, test point) pairs."""
    XV = phase.XV
    T = phase.tf - phase.t0
    sch = phase._scheme
    deg = 2 * phase._cs - 1
    S = phase.numSegs
    coef, hs, _ = _segment_coefs(phase)
    us = phase._traj[phase.seg_nodes, XV + 1:]               # (S, cs, UV)
    t0seg = phase.t0 + phase.seg_bounds[:-1] * T             # (S,)

    sig = _TEST_TAUS                                         # (ntau,)
    pw = sig[:, None] ** np.arange(deg + 1)                  # (ntau, deg+1)
    dpw = np.zeros((len(sig), deg + 1))
    dpw[:, 1:] = np.arange(1, deg + 1) * sig[:, None] ** np.arange(deg)
    x_t = np.einsum("td,sdx->stx", pw, coef)                 # (S, ntau, XV)
    dp_t = np.einsum("td,sdx->stx", dpw, coef)               # (S, ntau, XV)
    wU = np.stack([lagrange_weights(sch.cardinal_tau, sg) for sg in sig])
    u_t = np.einsum("tc,scu->stu", wU, us)                   # (S, ntau, UV)
    t_t = t0seg[:, None] + sig[None, :] * hs[:, None]        # (S, ntau)
    rows = np.concatenate(
        [x_t, t_t[:, :, None], u_t,
         np.broadcast_to(phase._odeparams, (S, len(sig), phase.PV))],
        axis=2).reshape(S * len(sig), -1)
    f = vmap(phase.ode.vf().trace)(config.tensor(rows)).cpu().numpy()
    f = f[:, :XV].reshape(S, len(sig), XV)
    res = np.abs(dp_t - hs[:, None, None] * f)
    return res.max(axis=(1, 2))


def _integrator_errors(phase):
    """Re-integrate each segment and compare endpoint states: all segments
    propagate in one batched adaptive-integrator call."""
    from ..Integrators import Integrator
    XV = phase.XV
    T = phase.tf - phase.t0
    step = 0.05 * T / max(phase.numSegs, 1)
    if phase.UV:
        # control columns of the XtU layout: the integrator closes the
        # loop on the table's interpolated controls only
        uvars = list(range(XV + 1, XV + 1 + phase.UV))
        integ = Integrator(phase.ode, step, phase.returnTrajTable(), uvars)
    else:
        integ = Integrator(phase.ode, step)
    rows0 = phase._traj[phase.seg_nodes[:, 0]]
    rows1 = phase._traj[phase.seg_nodes[:, -1]]
    x0s = np.concatenate(
        [rows0, np.tile(phase._odeparams, (len(rows0), 1))], axis=1)
    xfs = np.stack(integ.integrate_parallel(x0s, rows1[:, XV]))
    errs = np.max(np.abs(xfs[:, :XV] - rows1[:, :XV]), axis=1)
    if not np.isfinite(errs).all():
        raise FloatingPointError(
            "mesh error estimator 'integrator': the re-integration of "
            f"{int((~np.isfinite(errs)).sum())} segments is not finite")
    return errs


def _deboor_error_weight(sch, cs):
    """Hermite interpolation error constant for the scheme's cardinal taus:
    max over [0,1] of |prod_j (s - tau_j)^2| / (2cs)!.  Each cardinal state
    is matched in value and derivative, so the remainder carries the node
    polynomial squared."""
    s = np.linspace(0.0, 1.0, 4001)
    w = np.ones_like(s)
    for tc in sch.cardinal_tau:
        w *= (s - tc) ** 2
    return float(np.max(np.abs(w)) / math.factorial(2 * cs))


def _deboor_errors(phase):
    """De Boor derivative-jump estimator: per segment, estimate the deg-th
    derivative of the Hermite interpolant from its leading coefficient;
    jumps between neighboring segments estimate the (deg+1)-th derivative;
    error_k = |d^(deg+1) x| * h_k^(deg+1) * C."""
    sch = phase._scheme
    cs = phase._cs
    deg = 2 * cs - 1
    S = phase.numSegs
    coef, hs, _ = _segment_coefs(phase)
    # deg-th time derivative estimate on each segment
    y = coef[:, deg, :] * math.factorial(deg) / \
        np.abs(hs[:, None]) ** deg                           # (S, XV)

    EW = _deboor_error_weight(sch, cs)
    if S == 1:
        return np.array([np.max(np.abs(y[0]))
                         * np.abs(hs[0]) ** (deg + 1) * EW])
    # derivative jumps across interior boundaries -> (deg+1)-th derivative
    d = np.abs(np.diff(y, axis=0)) / (hs[:-1] + hs[1:])[:, None]
    e = np.zeros_like(y)
    e[1:] += d
    e[:-1] += d
    e[0] *= 2.0
    e[-1] *= 2.0
    return e.max(axis=1) * np.abs(hs) ** (deg + 1) * EW


def detect_switches(phase, jump_tol=0.1):
    """Control-switch detection: normalized segment boundaries where a
    control column jumps by more than jump_tol of its range."""
    UV = phase.UV
    if UV == 0 or phase.numSegs < 3:
        return np.zeros(0)
    cs = phase._cs
    traj = phase._traj
    switches = []
    for j in range(UV):
        u = traj[:, phase.XV + 1 + j]
        rng = np.max(u) - np.min(u)
        if rng <= 0:
            continue
        # jump of control across each interior segment boundary
        nl = phase.seg_nodes[:-1, max(cs - 2, 0)]
        nr = phase.seg_nodes[1:, min(1, cs - 1)]
        jump = np.abs(u[nr] - u[nl]) / rng > jump_tol
        switches.extend(phase.seg_bounds[1:-1][jump])
    return np.unique(np.asarray(switches))


def segment_errors(phase):
    est = phase.MeshErrorEstimator
    if est in ("deboor", "polynomial"):
        return _deboor_errors(phase)
    if est == "integrator":
        return _integrator_errors(phase)
    return _residual_errors(phase)


def trajectory_error(phase):
    return segment_errors(phase)


def _combine(errs, criteria):
    if criteria in ("avg", "mean"):
        return float(np.mean(errs))
    if criteria == "geometric":
        return float(np.exp(np.mean(np.log(np.maximum(errs, 1e-300)))))
    if criteria == "endtoend":
        return float(np.sum(errs))
    return float(np.max(errs))


def update_mesh(phase, errs):
    """Error-equidistributed re-binning: (new segment count, new
    normalized bounds)."""
    order = phase._scheme.order
    S = phase.numSegs
    err = _combine(errs, phase.MeshErrorCriteria)
    growth = (err * phase.MeshErrFactor / phase.MeshTol) ** (
        1.0 / (order + 1))
    n_new = int(np.ceil(S * np.clip(growth, phase.MeshRedFactor,
                                    phase.MeshIncFactor)))
    n_new = int(np.clip(n_new, phase.MinSegments, phase.MaxSegments))
    # Segment-count bucketing: quantize to a geometric ladder so that
    # consecutive mesh iterations land on repeated segment counts; the
    # transcription's structure key then matches and the whole KKT plan is
    # reused (transcribe() refreshes the consts only), for up to ~30% extra
    # segments an iteration.
    if phase.MeshBucketing:
        b = max(4, int(phase.MinSegments))
        while b < n_new:
            b = int(np.ceil(b * 1.3))
        n_new = int(min(b, phase.MaxSegments))

    # density ~ local error^(1/(order+1)), piecewise constant per old segment
    dens = np.maximum(errs, 1e-14) ** (1.0 / (order + 1))
    # control-switch detection: concentrate mesh density around detected
    # control discontinuities
    if phase.DetectControlSwitches:
        for tsw in detect_switches(phase, phase.SwitchTol):
            k = np.clip(np.searchsorted(phase.seg_bounds, tsw) - 1, 0,
                        phase.numSegs - 1)
            for kk in (k, min(k + 1, phase.numSegs - 1)):
                dens[kk] = max(dens[kk], np.max(dens) * 2.0)
    widths = np.diff(phase.seg_bounds)
    cum = np.concatenate([[0.0], np.cumsum(dens * widths)])
    cum /= cum[-1]
    targets = np.linspace(0.0, 1.0, n_new + 1)
    new_bounds = np.interp(targets, cum, phase.seg_bounds)
    new_bounds[0], new_bounds[-1] = 0.0, 1.0
    # enforce strictly increasing
    new_bounds = np.maximum.accumulate(new_bounds)
    for i in range(1, len(new_bounds)):
        if new_bounds[i] <= new_bounds[i - 1]:
            new_bounds[i] = new_bounds[i - 1] + 1e-10
    return n_new, new_bounds


def adaptive_mesh_loop(phase, method, flag):
    """Estimate -> refine -> re-transcribe -> re-solve until MeshTol or
    MaxMeshIters.  Re-solves are warm-started from the previous mesh's
    multipliers when the constraint dimensions carry over (a mesh-size
    change resets them; `PSIOPT._run` decides)."""
    phase.MeshConverged = False
    ws_prev = phase.optimizer.WarmStart
    phase.optimizer.WarmStart = True
    try:
        return _mesh_loop_body(phase, method, flag)
    finally:
        phase.optimizer.WarmStart = ws_prev


def _mesh_loop_body(phase, method, flag):
    for itr in range(phase.MaxMeshIters):
        errs = segment_errors(phase)
        err = _combine(errs, phase.MeshErrorCriteria)
        if phase.optimizer.PrintLevel <= 1:
            print(f"  [mesh] iter {itr}: segs {phase.numSegs} "
                  f"err {err:.3e} tol {phase.MeshTol:.1e}")
        if err < phase.MeshTol:
            phase.MeshConverged = True
            return flag
        n_new, bounds = update_mesh(phase, errs)
        # scheme-order re-interpolation onto the new mesh
        phase.resampleTraj(n_new, seg_bounds=bounds)
        flag = phase._psipot_call(method)
    phase.MeshConverged = False
    return flag
