"""LGLInterpTable / InterpFunction: differentiable trajectory interpolation.

Port of `asset_asrl_tpu/OptimalControl/interp_table.py`.  The table stores
trajectory rows and exposes time interpolation; InterpFunction wraps it as
a VectorFunction of time, so interpolated trajectories can appear inside
expressions (controller closures, link targets).  Interpolation is cubic
Hermite (Catmull-Rom tangents, or ODE tangents when an ODE is supplied),
or the transcription's own per-segment polynomials for a table built with
`from_phase`.

The table data are numpy arrays.  `interp_traced` is tensor code
(`torch.searchsorted` for the segment, gathers for its coefficients) that
runs under `torch.func.vmap` and forward-mode AD, because the integrator
closes control loops through it; the tensors it reads are built from the
numpy data on `config.DEVICE` at first use and kept per device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import config
from ..VectorFunctions.function import VectorFunction

__all__ = ["LGLInterpTable", "InterpFunction"]


def _powers(s, n):
    """[1, s, s^2, ..., s^(n-1)] by repeated products (exact derivative
    rules at s == 0)."""
    out = [torch.ones_like(s)]
    for _ in range(n - 1):
        out.append(out[-1] * s)
    return torch.stack(out)


def _segment_of(knots, t, last):
    """Index (a tensor of one element, so that gathers with it run under
    vmap) of the interval of the sorted `knots` that holds the scalar t,
    clamped to [0, last].  The search has no derivative and needs none."""
    k = torch.searchsorted(knots, t.detach().reshape(1), right=True) - 1
    return torch.clamp(k, 0, last)


def hermite_matrix_inverse(cardinal_tau, cs):
    """Inverse of the (2cs, 2cs) matrix that maps the coefficients of a
    degree-(2cs-1) polynomial in sigma to its values and derivatives at
    the scheme's cardinal taus."""
    deg = 2 * cs - 1
    A = np.zeros((2 * cs, deg + 1))
    for j, tc in enumerate(cardinal_tau):
        A[j] = tc ** np.arange(deg + 1)
        r = np.zeros(deg + 1)
        r[1:] = np.arange(1, deg + 1) * tc ** np.arange(deg)
        A[cs + j] = r
    return np.linalg.inv(A)


def node_rhs(phase):
    """The ODE right-hand side at all N nodes of a phase's trajectory, in
    one batched call on `config.DEVICE`: (N, XV) numpy."""
    traj = phase._traj
    rows = np.concatenate(
        [traj, np.tile(phase._odeparams, (traj.shape[0], 1))], axis=1)
    f = vmap(phase.ode.vf().trace)(config.tensor(rows))
    return f.cpu().numpy()[:, :phase.XV]


def segment_hermite(phase):
    """Hermite coefficients of every segment of a phase in one pass:
    (coef (S, deg+1, XV), hs (S,), fs_all (N, XV)): per segment the
    degree-(2cs-1) polynomial in local sigma matching (x_j, h f_j) at the
    scheme's cardinal taus."""
    cs, XV = phase._cs, phase.XV
    T = phase.tf - phase.t0
    fs_all = node_rhs(phase)
    Ainv = hermite_matrix_inverse(phase._scheme.cardinal_tau, cs)
    hs = np.diff(phase.seg_bounds) * T
    xs = phase._traj[phase.seg_nodes, :XV]
    fs = fs_all[phase.seg_nodes]
    rhs = np.concatenate([xs, hs[:, None, None] * fs], axis=1)
    coef = np.einsum("ij,sjx->six", Ainv, rhs)           # (S, deg+1, XV)
    return coef, hs, fs_all


class LGLInterpTable:

    @classmethod
    def from_phase(cls, phase):
        """Scheme-order table from a transcribed phase: per segment, the
        states use the same degree-(2cs-1) Hermite interpolant the LGL
        defects are built on (values + ODE tangents at the cs cardinal
        nodes) and the controls use the scheme's degree-(cs-1) Lagrange
        interpolant, so table lookups, re-sampling and controller closures
        keep the mesh's h^(2cs-2) accuracy instead of degrading to cubic."""
        sch = phase._scheme
        cs = phase._cs
        XV, UV = phase.XV, phase.UV
        traj = phase._traj
        T = phase.tf - phase.t0
        if not T > 0:
            # _seg_t must be strictly increasing for the searchsorted /
            # clip lookup below; a backward phase would silently return
            # wrong samples (corrupting resampleTraj output)
            raise ValueError(
                f"LGLInterpTable.from_phase: phase time must be forward "
                f"(t0={phase.t0}, tf={phase.tf})")
        S = phase.numSegs
        coef, hs, _ = segment_hermite(phase)
        # control Lagrange coefficients in sigma (degree cs-1)
        Au = np.stack([tc ** np.arange(cs) for tc in sch.cardinal_tau])
        us = traj[phase.seg_nodes, XV + 1:]              # (S, cs, UV)
        ucoef = np.einsum("ij,sju->siu", np.linalg.inv(Au), us) \
            if UV else np.zeros((S, cs, 0))

        tab = cls.__new__(cls)
        tab._ode = None
        tab._init_from_rows(np.asarray(traj), XV)
        tab._scheme_mode = True
        tab._seg_t = phase.t0 + phase.seg_bounds * T     # (S+1,)
        tab._seg_h = hs
        tab._coef = coef
        tab._ucoef = ucoef
        tab._deg = 2 * cs - 1
        tab._cs = cs
        tab._xv, tab._uv = XV, UV
        return tab

    def eval_batch(self, ts):
        """Vectorized scheme-order evaluation (numpy): (N,) times ->
        (N, XV+UV) value rows (no time column)."""
        if not self._scheme_mode:
            return np.stack([np.delete(self.Interpolate(t), self.tcol)
                             for t in np.asarray(ts, float)])
        ts = np.clip(np.asarray(ts, float), self._seg_t[0], self._seg_t[-1])
        k = np.clip(np.searchsorted(self._seg_t, ts, side="right") - 1,
                    0, len(self._seg_h) - 1)
        sig = (ts - self._seg_t[k]) / self._seg_h[k]
        pw = sig[:, None] ** np.arange(self._deg + 1)
        x = np.einsum("nd,ndx->nx", pw, self._coef[k])
        if self._uv:
            pu = sig[:, None] ** np.arange(self._cs)
            u = np.einsum("nd,ndu->nu", pu, self._ucoef[k])
            return np.concatenate([x, u], axis=1)
        return x

    def __init__(self, *args):
        """Forms:
        LGLInterpTable(odevf, XV, UV, traj)      tangents from the ODE
        LGLInterpTable(traj)                     time in the last column
        LGLInterpTable(ncols, data, nrows_or_ts) raw value rows + time last
        """
        ode = None
        if len(args) == 4:
            ode, xv, uv, traj = args
            rows = np.asarray([np.asarray(r).ravel() for r in traj])
            tcol = int(xv)
        elif len(args) == 1:
            rows = np.asarray([np.asarray(r).ravel() for r in args[0]])
            tcol = rows.shape[1] - 1
        elif len(args) in (2, 3):
            rows = np.asarray([np.asarray(r).ravel() for r in args[1]])
            tcol = int(args[0])
        else:
            raise TypeError("LGLInterpTable: bad arguments")
        self._ode = ode
        self._init_from_rows(rows, tcol, ode)

    def _init_from_rows(self, rows, tcol, ode=None):
        self._scheme_mode = False
        self._dev_tensors = {}
        self.tcol = tcol
        rows = rows[np.argsort(rows[:, tcol])]
        self.ts = rows[:, tcol].copy()
        self.vals = np.delete(rows, tcol, axis=1)
        self.rows = rows
        self.TotalT = float(self.ts[-1] - self.ts[0])
        self.T0 = float(self.ts[0])
        self.TF = float(self.ts[-1])
        # Catmull-Rom tangents (one-sided at the ends)
        t, v = self.ts, self.vals
        dv = np.zeros_like(v)
        if len(t) > 1:
            dv[1:-1] = (v[2:] - v[:-2]) / (t[2:] - t[:-2])[:, None]
            dv[0] = (v[1] - v[0]) / (t[1] - t[0])
            dv[-1] = (v[-1] - v[-2]) / (t[-1] - t[-2])
        if ode is not None:
            # exact tangents for the state columns from the ODE RHS, all
            # rows in one batched call
            f = vmap(ode.trace)(config.tensor(rows[:, :ode.IRows()]))
            dv[:, :ode.ORows()] = f.cpu().numpy()
        self.tangents = dv

    # -------------------------------------------------------------- queries
    def _tensors(self):
        """The table's data as tensors on `config.DEVICE` (built at first
        use, kept per device)."""
        dev = config.DEVICE
        t = self._dev_tensors.get(dev)
        if t is None:
            if self._scheme_mode:
                t = tuple(config.cached(a, dev) for a in (
                    self._seg_t, self._seg_h, self._coef, self._ucoef))
            else:
                t = tuple(config.cached(a, dev) for a in (
                    self.ts, self.vals, self.tangents))
            self._dev_tensors[dev] = t
        return t

    def interp_traced(self, t):
        """Interpolation at a scalar tensor time t -> row of all value
        columns: the scheme's own per-segment polynomials when built with
        from_phase (order-consistent), cubic Hermite otherwise."""
        if self._scheme_mode:
            st, sh, coef, ucoef = self._tensors()
            tcl = config.clip(t, st[0], st[-1])
            k = _segment_of(st, tcl, sh.shape[0] - 1)
            sig = (tcl - st[k][0]) / sh[k][0]
            x = _powers(sig, self._deg + 1) @ coef[k][0]
            if self._uv:
                return torch.cat([x, _powers(sig, self._cs) @ ucoef[k][0]])
            return x
        ts, vs, dvs = self._tensors()
        t = config.clip(t, ts[0], ts[-1])
        k = _segment_of(ts, t, ts.shape[0] - 2)
        t0, t1 = ts[k][0], ts[k + 1][0]
        h = t1 - t0
        s = (t - t0) / h
        s2 = s * s
        s3 = s2 * s
        h00 = 2 * s3 - 3 * s2 + 1
        h10 = s3 - 2 * s2 + s
        h01 = -2 * s3 + 3 * s2
        h11 = s3 - s2
        return (h00 * vs[k][0] + h10 * h * dvs[k][0]
                + h01 * vs[k + 1][0] + h11 * h * dvs[k + 1][0])

    def Interpolate(self, t):
        out = self.interp_traced(config.tensor(float(t))).cpu().numpy()
        return np.insert(out, self.tcol, float(t))

    def InterpolateDeriv(self, t):
        g = jacfwd(self.interp_traced)(config.tensor(float(t)))
        return g.cpu().numpy()

    def __call__(self, t):
        return self.Interpolate(t)

    def InterpRange(self, n, t0=None, tf=None):
        t0 = self.T0 if t0 is None else t0
        tf = self.TF if tf is None else tf
        return [self.Interpolate(t) for t in np.linspace(t0, tf, int(n))]

    def InterpWholeRange(self, n):
        return self.InterpRange(n)

    def makePeriodic(self):
        pass  # clamped interpolation already wraps at the ends


def InterpFunction(tab: LGLInterpTable, idx):
    """VectorFunction of time: t -> the selected interpolated columns."""
    idx = [int(i) for i in idx]

    def impl(x):
        row = tab.interp_traced(x[0])
        return torch.stack([row[i] for i in idx])

    return VectorFunction(impl, 1, len(idx), name="InterpFunction")


def InterpFunction_1(tab):
    return InterpFunction(tab, range(1))


def InterpFunction_3(tab):
    return InterpFunction(tab, range(3))


def InterpFunction_6(tab):
    return InterpFunction(tab, range(6))
