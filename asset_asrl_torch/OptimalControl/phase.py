"""Phase: collocation transcription of one ODE over a mesh + user API.

Port of `asset_asrl_tpu/OptimalControl/phase.py`, main-path subset: LGL3,
LGL5 and LGL7 defects, the FirstOrderSpline control mode, boundary values,
variable bounds and integral objectives, solved by PSIOPT on the block KKT.

* Variable layout: [ (x_i, u_i) for node i ] ++ [t0, tf] ++ [ODE params]
  (the JAX package's layout without static parameters).  Node times are affine in t0/tf through the fixed
  normalized mesh tau_i, so the KKT is block-banded in node index with a
  small dense border.
* Every constraint/objective becomes an IndexedFunction family: one torch
  closure + a (napps, nin) gather matrix + per-application constants,
  evaluated with one vmap per family.  Closure constants (scheme
  coefficient matrices, indices) are tensors on the problem's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..VectorFunctions.function import VectorFunction
from ..Solvers.nlp import NonLinearProgram, IndexedFunction
from ..Solvers.psiopt import PSIOPT
from .lgl import get_scheme

__all__ = ["Phase", "PhaseRegionFlags", "TranscriptionModes", "ControlModes"]


class TranscriptionModes:
    LGL3 = "LGL3"
    LGL5 = "LGL5"
    LGL7 = "LGL7"


class ControlModes:
    FirstOrderSpline = "FirstOrderSpline"


class PhaseRegionFlags:
    Front = "Front"
    Back = "Back"
    Path = "Path"
    InnerPath = "InnerPath"
    FrontandBack = "FrontandBack"
    BackandFront = "BackandFront"
    PairWisePath = "PairWisePath"


_REGION_ALIASES = {
    "First": "Front", "Last": "Back", "FirstandLast": "FrontandBack",
    "LastandFirst": "BackandFront", "NodalPath": "Path",
}


def _canon_region(reg):
    reg = str(reg)
    return _REGION_ALIASES.get(reg, reg)


def _tracefun(f):
    if isinstance(f, VectorFunction):
        return f.trace, f.IRows(), f.ORows()
    raise TypeError("expected a VectorFunction")


class _Spec:
    """One user-added constraint/objective, pre-transcription.  `data`
    (optional (ndata,)) is constant data (boundary values) that rides in
    the family consts; a data-carrying spec's fun has signature
    fun(full_region_input, data)."""

    def __init__(self, kind, region, fun, nout, name, data=None):
        self.kind = kind          # 'eq' | 'iq' | 'intobj'
        self.region = region
        self.fun = fun
        self.nout = nout
        self.name = name
        self.data = None if data is None else \
            np.asarray(data, np.float64).ravel()


class Phase:

    def __init__(self, ode, tmode, IG=None, numsegs=None):
        self.ode = ode
        # the device the expression constants live on (config.DEVICE);
        # passed down to the NLP and the KKT backend
        self.device = config.DEVICE
        self.TranscriptionMode = str(tmode)
        self.ControlMode = ControlModes.FirstOrderSpline
        self.XV, self.UV, self.PV = ode.XVars(), ode.UVars(), ode.PVars()
        self.optimizer = PSIOPT()
        self._specs: list[_Spec] = []
        self._numsegs = None
        self._traj = None                  # node rows [x, t, u]
        self._odeparams = np.zeros(self.PV)
        self._nlp = None
        self._need_transcribe = True
        if numsegs is not None:
            self.setTraj(IG, numsegs)
        elif IG is not None:
            self.setTraj(IG, max(len(IG) - 1, 4))

    # ------------------------------------------------------------------ mesh
    def _node_structure(self, numsegs):
        """Nodes-per-segment layout and normalized node times (uniform
        segments)."""
        tm = self.TranscriptionMode
        S = int(numsegs)
        cs = {"LGL3": 2, "LGL5": 3, "LGL7": 4}.get(tm)
        if cs is None:
            raise NotImplementedError(
                f"transcription mode {tm} is not ported yet (ROADMAP queue "
                "1, item 10)")
        self._cs = cs
        self._scheme = get_scheme(tm)
        self.numSegs = S
        self.numNodes = S * (cs - 1) + 1
        bounds = np.linspace(0.0, 1.0, S + 1)
        taus = [0.0]
        for k in range(S):
            a, b = bounds[k], bounds[k + 1]
            for ct in self._scheme.cardinal_tau[1:]:
                taus.append(a + ct * (b - a))
        self.taus = np.asarray(taus)
        self.seg_bounds = bounds
        self.seg_nodes = np.stack([
            np.arange(k * (cs - 1), k * (cs - 1) + cs) for k in range(S)])

    # -------------------------------------------------------- variable layout
    @property
    def _m(self):
        return self.XV + self.UV

    @property
    def _t0i(self):
        return self.numNodes * self._m

    @property
    def _tfi(self):
        return self._t0i + 1

    def _opi(self, k):
        return self._tfi + 1 + k

    @property
    def numVars(self):
        return self.numNodes * self._m + 2 + self.PV

    # ------------------------------------------------------------------- IG
    def setTraj(self, IG, numsegs=None):
        IG = np.asarray([np.asarray(r, dtype=np.float64).ravel() for r in IG])
        need = self.XV + 1 + self.UV
        if IG.shape[1] < need:
            raise ValueError(
                f"IG rows must have at least {need} entries [x,t,u]")
        if numsegs is None:
            numsegs = self._numsegs or max(len(IG) - 1, 4)
        self._numsegs = int(numsegs)
        self._node_structure(self._numsegs)
        tcol = IG[:, self.XV]
        self.t0 = float(tcol[0])
        self.tf = float(tcol[-1])
        span = self.tf - self.t0 if self.tf != self.t0 else 1.0
        tau_ig = np.maximum.accumulate((tcol - self.t0) / span)
        node_rows = np.empty((self.numNodes, self.XV + 1 + self.UV))
        for c in range(self.XV):
            node_rows[:, c] = np.interp(self.taus, tau_ig, IG[:, c])
        node_rows[:, self.XV] = self.t0 + self.taus * span
        for j in range(self.UV):
            node_rows[:, self.XV + 1 + j] = np.interp(
                self.taus, tau_ig, IG[:, self.XV + 1 + j])
        self._traj = node_rows
        if self.PV > 0 and IG.shape[1] >= need + self.PV:
            self._odeparams = IG[:, need:need + self.PV].mean(axis=0)
        self._need_transcribe = True

    # ------------------------------------------------- region input assembly
    def _region_apps(self, region):
        """Node tuples + taus per application for a node-based region."""
        N = self.numNodes
        region = _canon_region(region)
        if region == "Front":
            return [(0,)], [(0.0,)]
        if region == "Back":
            return [(N - 1,)], [(1.0,)]
        if region == "Path":
            return [(i,) for i in range(N)], [(self.taus[i],)
                                              for i in range(N)]
        if region == "InnerPath":
            return [(i,) for i in range(1, N - 1)], \
                [(self.taus[i],) for i in range(1, N - 1)]
        if region == "FrontandBack":
            return [(0, N - 1)], [(0.0, 1.0)]
        if region == "BackandFront":
            return [(N - 1, 0)], [(1.0, 0.0)]
        if region == "PairWisePath":
            return [(i, i + 1) for i in range(N - 1)], \
                [(self.taus[i], self.taus[i + 1]) for i in range(N - 1)]
        raise ValueError(f"unsupported phase region: {region}")

    def _gather_nodes(self, nodes_per_app):
        """Vidx rows: [node vars ..., t0, tf, odeparams]."""
        m = self._m
        nodes = np.asarray(nodes_per_app, np.int64)          # (napps, nn)
        per_node = nodes[:, :, None] * m + np.arange(m)[None, None, :]
        tail = np.asarray([self._t0i, self._tfi]
                          + [self._opi(k) for k in range(self.PV)],
                          np.int64)
        return np.concatenate(
            [per_node.reshape(len(nodes), -1),
             np.broadcast_to(tail, (len(nodes), len(tail)))], axis=1)

    def _region_input_fun(self, user_fun, nnodes, with_data=False):
        """Wrap user_fun (input [xtu_1, ..., xtu_k, op]) over the gathered
        variables [nodevars..., t0, tf, op] with node times
        affine in (t0, tf).  with_data: user_fun also receives the data
        columns of the consts row (c[nnodes:])."""
        XV = self.XV
        m = self._m

        def fun(g, c):
            t0 = g[nnodes * m]
            tf = g[nnodes * m + 1]
            parts = []
            for j in range(nnodes):
                t = t0 * (1.0 - c[j]) + tf * c[j]
                parts.extend([g[j * m:j * m + XV], t[None],
                              g[j * m + XV:(j + 1) * m]])
            parts.append(g[nnodes * m + 2:])   # ODE params
            inp = torch.cat(parts)
            if with_data:
                return torch.atleast_1d(user_fun(inp, c[nnodes:]))
            return torch.atleast_1d(user_fun(inp))
        return fun

    def _region_family(self, region, user_fun, name, data=None):
        region = _canon_region(region)
        apps, taus = self._region_apps(region)
        Vidx = self._gather_nodes(apps)
        consts = np.asarray(taus, dtype=np.float64)
        if data is not None:
            consts = np.concatenate(
                [consts, np.tile(data, (len(apps), 1))], axis=1)
        fun = self._region_input_fun(user_fun, len(apps[0]),
                                     with_data=data is not None)
        return IndexedFunction(fun, Vidx, consts, name=name)

    # ------------------------------------------------------------- user API
    def _resolve_idx(self, indices):
        if isinstance(indices, (int, np.integer)):
            return np.asarray([indices], dtype=np.int64)
        return np.asarray([int(v) for v in indices], dtype=np.int64)

    def _add(self, kind, region, fun, nout, name, data=None):
        self._specs.append(_Spec(kind, region, fun, nout, name, data=data))
        self._need_transcribe = True
        return len(self._specs) - 1

    def addBoundaryValue(self, region, indices, values):
        idx = config.index(self._resolve_idx(indices), self.device)
        vals = np.asarray(values, dtype=np.float64).ravel()

        def fun(inp, d):
            return inp[idx] - d
        return self._add("eq", region, fun, int(idx.shape[0]), "boundary",
                         data=vals)

    def addLUVarBound(self, region, var, lb, ub, scale=1.0):
        if not isinstance(var, (int, np.integer)):
            resolved = self._resolve_idx(var)
            if len(resolved) > 1:
                return [self.addLUVarBound(region, int(v), lb, ub, scale)
                        for v in resolved]
            var = int(resolved[0])
        var = int(var)
        lb, ub, s = float(lb), float(ub), float(scale)

        def fun(inp):
            v = inp[var]
            return torch.stack([(lb - v) * s, (v - ub) * s])
        return self._add("iq", region, fun, 2, "luvarbound")

    def addIntegralObjective(self, func, indices):
        trace, ir, orr = _tracefun(func)
        if orr != 1:
            raise ValueError("integral objective must be scalar")
        idx = self._resolve_idx(indices)
        if len(idx) != ir:
            raise ValueError("index list width != function input size")
        return self._add("intobj", "Integral", (trace, idx), 1, "intobj")

    # ------------------------------------------------------------ transcribe
    def _defect_family(self):
        """Hermite-LGL defects of every segment (LGL3/5/7)."""
        cs = self._cs
        sch = self._scheme
        XV, PV = self.XV, self.PV
        m = self._m
        ode_rhs = self.ode.vf().trace
        dev = self.device

        x_int = config.tensor(sch.x_interp, dev)
        dx_int = config.tensor(sch.dx_interp, dev)
        u_int = config.tensor(sch.u_interp, dev)
        x_def = config.tensor(sch.x_def, dev)
        dx_def = config.tensor(sch.dx_def, dev)
        i_def = config.tensor(sch.int_def, dev)
        ctau = config.tensor(sch.cardinal_tau, dev)
        itau = config.tensor(sch.interior_tau, dev)

        def fun(g, c):
            t0 = g[cs * m]
            tf = g[cs * m + 1]
            p = g[cs * m + 2:cs * m + 2 + PV]
            T = tf - t0
            dtau = c[1] - c[0]
            h = dtau * T
            xs = torch.stack([g[j * m:j * m + XV] for j in range(cs)])
            us = torch.stack([g[j * m + XV:(j + 1) * m] for j in range(cs)])
            ts = t0 + (c[0] + ctau * dtau) * T
            fs = torch.stack([
                ode_rhs(torch.cat([xs[j], ts[j][None], us[j], p]))
                for j in range(cs)])
            x_i = x_int @ xs + h * (dx_int @ fs)        # (cs-1, XV)
            u_i = u_int @ us                            # (cs-1, UV)
            t_i = t0 + (c[0] + itau * dtau) * T
            f_i = torch.stack([
                ode_rhs(torch.cat([x_i[i], t_i[i][None], u_i[i], p]))
                for i in range(cs - 1)])
            d = x_def @ xs + h * (dx_def @ fs) + h * (i_def[:, None] * f_i)
            return d.reshape(-1)

        apps = [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]
        Vidx = self._gather_nodes(apps)
        consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]], axis=1)
        return IndexedFunction(fun, Vidx, consts, name="defects")

    def _control_families(self):
        """FirstOrderSpline: interior cardinal controls are the linear
        interpolation of the segment's end controls."""
        cs, UV, m, XV = self._cs, self.UV, self._m, self.XV
        if UV == 0 or cs == 2:
            return []
        ct = self._scheme.cardinal_tau
        w = config.tensor([[1.0 - ct[j], ct[j]] for j in range(1, cs - 1)],
                          self.device)

        def fun(g, c):
            us = torch.stack([g[j * m + XV:(j + 1) * m] for j in range(cs)])
            lin = w @ torch.stack([us[0], us[-1]])
            return (us[1:cs - 1] - lin).reshape(-1)
        apps = [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]
        consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]], axis=1)
        return [IndexedFunction(fun, self._gather_nodes(apps), consts,
                                name="uspline1")]

    def _integral_family(self, trace, idx):
        """Per-segment quadrature family with the reduced (cardinal-only)
        weights."""
        cs, m, XV = self._cs, self._m, self.XV
        sch = self._scheme
        wq = config.tensor(sch.quad_reduced, self.device)
        ctau = [float(t) for t in sch.cardinal_tau]
        idxj = config.index(idx, self.device)

        def fun(g, c):
            t0 = g[cs * m]
            tf = g[cs * m + 1]
            T = tf - t0
            dtau = c[1] - c[0]
            h = dtau * T
            vals = []
            for j in range(cs):
                t = t0 + (c[0] + ctau[j] * dtau) * T
                xtu = torch.cat([g[j * m:j * m + XV], t[None],
                                 g[j * m + XV:(j + 1) * m], g[cs * m + 2:]])
                vals.append(trace(xtu[idxj])[0])
            return (h * (wq @ torch.stack(vals)))[None]

        apps = [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]
        consts = np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]], axis=1)
        return IndexedFunction(fun, self._gather_nodes(apps), consts,
                               name="integral")

    def _build_families(self):
        """(eqs, iqs, objs) IndexedFunction lists in phase-local indices."""
        eqs = [self._defect_family()] + self._control_families()
        iqs, objs = [], []
        for spec in self._specs:
            if spec.kind == "intobj":
                objs.append(self._integral_family(*spec.fun))
            elif spec.kind == "eq":
                eqs.append(self._region_family(spec.region, spec.fun,
                                               spec.name, data=spec.data))
            elif spec.kind == "iq":
                iqs.append(self._region_family(spec.region, spec.fun,
                                               spec.name, data=spec.data))
        return eqs, iqs, objs

    def node_of_var(self):
        """Node id per phase variable (-1 = border: t0, tf, params): the
        structure map of the block-tridiagonal KKT backend."""
        nov = np.full(self.numVars, -1, np.int64)
        m = self._m
        nov[:self.numNodes * m] = np.arange(self.numNodes * m) // m
        return nov

    def transcribe(self):
        from ..Solvers.kkt_block import BlockKKT
        nlp = NonLinearProgram(self.numVars, device=self.device)
        eqs, iqs, objs = self._build_families()
        for f in eqs:
            nlp.addEqualCon(f)
        for f in iqs:
            nlp.addInequalCon(f)
        for f in objs:
            nlp.addObjective(f)
        nlp.freeze()
        self._nlp = nlp
        try:
            kkt = BlockKKT(nlp, self.node_of_var(),
                           x0=self.makeSolverInput())
        except ValueError as e:
            raise NotImplementedError(
                "this problem does not fit the block KKT structure and the "
                "dense KKT backend is not ported yet (ROADMAP queue 1, item "
                f"6): {e}") from e
        self.optimizer.setNLP(nlp, kkt)
        self._need_transcribe = False

    # --------------------------------------------------------- solve entries
    def makeSolverInput(self):
        m = self._m
        V = np.zeros(self.numVars)
        nodes = V[:self.numNodes * m].reshape(self.numNodes, m)
        nodes[:, :self.XV] = self._traj[:, :self.XV]
        nodes[:, self.XV:] = self._traj[:, self.XV + 1:]
        V[self._t0i] = self.t0
        V[self._tfi] = self.tf
        for k in range(self.PV):
            V[self._opi(k)] = self._odeparams[k]
        return V

    def collectSolverOutput(self, V):
        V = np.asarray(V, np.float64)
        m = self._m
        self.t0 = float(V[self._t0i])
        self.tf = float(V[self._tfi])
        nodes = V[:self.numNodes * m].reshape(self.numNodes, m)
        traj = np.empty((self.numNodes, self.XV + 1 + self.UV))
        traj[:, :self.XV] = nodes[:, :self.XV]
        traj[:, self.XV] = self.t0 + self.taus * (self.tf - self.t0)
        traj[:, self.XV + 1:] = nodes[:, self.XV:]
        self._traj = traj
        for k in range(self.PV):
            self._odeparams[k] = V[self._opi(k)]

    def _psiopt_call(self, method):
        if self._need_transcribe or self._nlp is None:
            self.transcribe()
        V = getattr(self.optimizer, method)(self.makeSolverInput())
        self.collectSolverOutput(V)
        return self.optimizer.ConvergeFlag

    def optimize(self):
        return self._psiopt_call("optimize")

    # ----------------------------------------------------------- extraction
    def returnTraj(self):
        out = self._traj.copy()
        if self.PV > 0:
            out = np.hstack([out, np.tile(self._odeparams,
                                          (out.shape[0], 1))])
        return [row.copy() for row in out]
