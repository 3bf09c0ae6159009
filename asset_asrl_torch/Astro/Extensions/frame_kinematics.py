"""Differentiable ephemeris kinematics.

Port of `asset_asrl_tpu/Astro/Extensions/frame_kinematics.py`.  The
reference derives rotating-frame data (rotation matrices, angular
velocity and its rate, barycenter acceleration, pulsation scales) by
finite-difference tables over sampled ephemerides
(`asset_asrl/Astro/Extensions/EPPRFrame.py` CalcFrameData).  Here the
ephemeris is a smooth tensor function of time (Hermite interpolation
with the tabulated velocities as exact position tangents) and every
derived quantity is a `torch.func` derivative of it: W from the rotation
matrix's time derivative, Wdot/Rddot/BCacc from one more `jacfwd`.  One
`vmap` sweep over the sample times fills each table.  The interval of a
time comes from `torch.searchsorted` on the detached time as a
one-element index, and the knots are read with `torch.index_select`, so
the lookup runs under `vmap(jacfwd(...))`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ... import config
from ..kepler import _cross


class DifferentiableEphemeris:
    """Smooth state(t) from ephemeris rows [r(3), v(3), t].

    Positions interpolate with the tabulated velocities as exact Hermite
    tangents; velocities interpolate with centered-difference
    acceleration tangents, so state() is C1 and `torch.func` can
    differentiate it (twice, piecewise) for frame kinematics."""

    def __init__(self, rows):
        rows = np.asarray([np.asarray(r, np.float64).ravel() for r in rows])
        order = np.argsort(rows[:, 6])
        rows = rows[order]
        self.ts = rows[:, 6].copy()
        self.pos = rows[:, 0:3].copy()
        self.vel = rows[:, 3:6].copy()
        t, v = self.ts, self.vel
        acc = np.zeros_like(v)
        if len(t) > 2:
            acc[1:-1] = (v[2:] - v[:-2]) / (t[2:] - t[:-2])[:, None]
            acc[0] = (v[1] - v[0]) / (t[1] - t[0])
            acc[-1] = (v[-1] - v[-2]) / (t[-1] - t[-2])
        self.acc = acc
        self._dev = {}

    def _tensors(self, device):
        got = self._dev.get(device)
        if got is None:
            got = {k: config.cached(getattr(self, k), device)
                   for k in ("ts", "pos", "vel", "acc")}
            self._dev[device] = got
        return got

    def _hermite(self, t, vals, tans):
        d = self._tensors(t.device)
        ts, vals, tans = d["ts"], d[vals], d[tans]
        n = ts.shape[0]
        t = config.clip(t, ts[0], ts[n - 1])
        k = torch.clamp(torch.searchsorted(ts, t.detach().reshape(1),
                                           right=True) - 1, 0, n - 2)
        t0 = torch.index_select(ts, 0, k)[0]
        t1 = torch.index_select(ts, 0, k + 1)[0]
        h = t1 - t0
        s = (t - t0) / h
        v0 = torch.index_select(vals, 0, k)[0]
        v1 = torch.index_select(vals, 0, k + 1)[0]
        m0 = torch.index_select(tans, 0, k)[0] * h
        m1 = torch.index_select(tans, 0, k + 1)[0] * h
        s2, s3 = s * s, s * s * s
        return ((2 * s3 - 3 * s2 + 1) * v0 + (s3 - 2 * s2 + s) * m0
                + (-2 * s3 + 3 * s2) * v1 + (s3 - s2) * m1)

    def r(self, t):
        return self._hermite(t, "pos", "vel")

    def v(self, t):
        return self._hermite(t, "vel", "acc")

    def state(self, t):
        return torch.cat([self.r(t), self.v(t)])


def _norm(v):
    return torch.sqrt(v @ v)


def rotating_frame_samples(eph1, eph2, mfrac1, mfrac2, ts):
    """Sample every pulsating-rotating-frame quantity at times `ts` by
    automatic differentiation of the two ephemeris interpolants.

    mfrac1/mfrac2: P1/P2 mass fractions (sum 1).  Returns a dict of
    (N, ...) arrays: DCM rows (xhat|yhat|zhat), W and Wdot in FRAME
    coordinates, R/Rdot/Rddot, barycenter state and the frame-correction
    acceleration -DCM^T vbc_dot / R, and the EOM scale factors."""
    def relstate(t):
        return eph2.state(t) - eph1.state(t)

    def axes(t):
        s = relstate(t)
        r, v = s[:3], s[3:]
        xh = r / _norm(r)
        h = _cross(r, v)
        zh = h / _norm(h)
        yh = _cross(zh, xh)
        return torch.stack([xh, yh, zh], dim=1)     # columns = axes

    def w_inertial(t):
        DCM = axes(t)
        dDCM = jacfwd(axes)(t)
        Om = dDCM @ DCM.T
        return torch.stack([Om[2, 1], Om[0, 2], Om[1, 0]])

    def w_frame(t):
        return axes(t).T @ w_inertial(t)

    def sep(t):
        return _norm(relstate(t)[:3])

    def sepdot(t):
        s = relstate(t)
        return s[:3] @ s[3:] / _norm(s[:3])

    def vbc(t):
        return mfrac1 * eph1.v(t) + mfrac2 * eph2.v(t)

    def bc_frame_acc(t):
        # frame-correction acceleration: -DCM^T a_bc / R
        abc = jacfwd(vbc)(t)
        return -(axes(t).T @ abc) / sep(t)

    def host(a):
        return a.detach().cpu().numpy()

    ts = config.tensor(np.asarray(ts, np.float64))
    DCM = host(vmap(axes)(ts))
    W = host(vmap(w_frame)(ts))
    Wdot = host(vmap(jacfwd(w_frame))(ts))
    R = host(vmap(sep)(ts))
    Rdot = host(vmap(sepdot)(ts))
    Rddot = host(vmap(jacfwd(sepdot))(ts))
    BCacc = host(vmap(bc_frame_acc)(ts))
    BC = host(vmap(lambda t: mfrac1 * eph1.state(t)
                   + mfrac2 * eph2.state(t))(ts))
    return dict(
        ts=host(ts),
        # rows of the table are [xhat | yhat | zhat] (DCM columns)
        rot=DCM.transpose(0, 2, 1).reshape(len(ts), 9),
        W=W, Wdot=Wdot, R=R, Rdot=Rdot, Rddot=Rddot, BC=BC, BCacc=BCacc,
        Gscale=R ** (-3.0),
        Accscale=1.0 / R,
        Vscale=-2.0 * Rdot / R,
        Rscale=-Rddot / R,
    )


def center_acceleration_samples(eph, ts):
    """-a_P1(t) at `ts` by AD of the velocity interpolant (the inertial
    frame-correction of a P1-centered frame)."""
    acc = vmap(jacfwd(eph.v))(config.tensor(np.asarray(ts, np.float64)))
    return -acc.detach().cpu().numpy()


class BodyRegistry:
    """Third-body catalog shared by the ephemeris frames: position interp
    tables + nondimensional mu per registered body."""

    def _init_body_registry(self):
        self.AltBodyGTables = {}
        self.AltBodyLocFuncs = {}
        self.AltBodyMuVals = {}
        self.AltBodyNames = []

    def register_body(self, name, rows, mu_nd):
        from ...OptimalControl.interp_table import (LGLInterpTable,
                                                    InterpFunction)
        pos_rows = [np.array([q[0], q[1], q[2], q[-1]]) for q in rows]
        tab = LGLInterpTable(3, pos_rows, len(pos_rows))
        self.AltBodyGTables[name] = tab
        self.AltBodyLocFuncs[name] = InterpFunction(tab, range(3))
        self.AltBodyMuVals[name] = mu_nd
        self.AltBodyNames.append(name)
