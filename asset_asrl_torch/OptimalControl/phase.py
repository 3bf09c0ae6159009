"""Phase: collocation transcription of one ODE over a mesh + user API.

Port of `asset_asrl_tpu/OptimalControl/phase.py`: the LGL3/5/7, Trapezoidal
and CentralShooting transcriptions, the four control modes, static
parameters and the constraint/objective API, uniform and non-uniform
meshes with adaptive refinement (`mesh.py`), units and auto-scaling,
trajectory tables and costates, solved by PSIOPT on the block KKT (or the
dense KKT when the structure does not fit it).

* Variable layout: [ (x_i, u_i) for node i ] ++ [t0, tf] ++ [ODE params]
  ++ [static params].  Node times are affine in t0/tf through the fixed
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
from ..Solvers.nlp import NonLinearProgram, IndexedFunction, _family_valjac
from ..Solvers.psiopt import PSIOPT
from .lgl import get_scheme

__all__ = ["Phase", "PhaseRegionFlags", "TranscriptionModes", "ControlModes"]


class TranscriptionModes:
    LGL3 = "LGL3"
    LGL5 = "LGL5"
    LGL7 = "LGL7"
    Trapezoidal = "Trapezoidal"
    CentralShooting = "CentralShooting"


class ControlModes:
    HighestOrderSpline = "HighestOrderSpline"
    FirstOrderSpline = "FirstOrderSpline"
    NoSpline = "NoSpline"
    BlockConstant = "BlockConstant"


class PhaseRegionFlags:
    Front = "Front"
    Back = "Back"
    Path = "Path"
    InnerPath = "InnerPath"
    NodalPath = "NodalPath"
    FrontandBack = "FrontandBack"
    BackandFront = "BackandFront"
    PairWisePath = "PairWisePath"
    ODEParams = "ODEParams"
    StaticParams = "StaticParams"


_REGION_ALIASES = {
    "First": "Front", "Last": "Back", "FirstandLast": "FrontandBack",
    "LastandFirst": "BackandFront", "NodalPath": "Path",
}
_PARAM_REGIONS = ("ODEParams", "StaticParams")
_PAIR_REGIONS = ("FrontandBack", "BackandFront", "PairWisePath")


def _canon_region(reg):
    reg = str(reg)
    return _REGION_ALIASES.get(reg, reg)


def _tracefun(f):
    if isinstance(f, VectorFunction):
        return f.trace, f.IRows(), f.ORows()
    raise TypeError("expected a VectorFunction")


class _Spec:
    """One user-added constraint/objective, pre-transcription.  `data`
    (optional (ndata,)) is constant data (boundary values, lock targets)
    that rides in the family consts, so `subVariables` can change it
    between solves without re-transcription; a data-carrying spec's fun
    has signature fun(full_region_input, data)."""

    def __init__(self, kind, region, fun, nout, name, data=None):
        self.kind = kind          # 'eq' | 'iq' | 'obj' | 'intobj' | 'inteq'
        self.region = region
        self.fun = fun
        self.nout = nout
        self.name = name
        self.data = None if data is None else \
            np.asarray(data, np.float64).ravel()


class Phase:

    def __init__(self, ode, tmode, IG=None, numsegs=None, spacefun=None):
        self.ode = ode
        # the device the expression constants live on (config.DEVICE);
        # passed down to the NLP and the KKT backend
        self.device = config.DEVICE
        self.TranscriptionMode = str(tmode)
        self.ControlMode = ControlModes.FirstOrderSpline
        self.XV, self.UV, self.PV = ode.XVars(), ode.UVars(), ode.PVars()
        self.SPV = 0
        self._static_params = np.zeros(0)
        self.KKTBackend = "block"
        self.optimizer = PSIOPT()
        self._specs: list[_Spec] = []
        self.AdaptiveMesh = False
        self.MeshTol = 1.0e-6
        self.MaxMeshIters = 10
        self.MeshErrorEstimator = "integrator"
        self.MeshErrorCriteria = "max"
        self.MeshRedFactor = 0.5
        self.MeshIncFactor = 5.0
        self.MinSegments = 4
        self.MaxSegments = 10000
        self.MeshErrFactor = 10.0
        self.MeshConverged = False
        # quantize new segment counts to a geometric ladder, so that
        # consecutive mesh iterations repeat counts and reuse the
        # transcription (see `mesh.update_mesh`)
        self.MeshBucketing = True
        self.DetectControlSwitches = False
        self.SwitchTol = 0.1
        self.NumExtraAddsPerSwitch = 4
        self.AutoScaling = False
        self._units = None
        self._xtup_units = None     # canonical unit per XtUP variable
        self._scale_vec = None      # unit per phase variable when scaling
        self._obj_scale = None      # the synchronized objective row scale
        self._integrator = None
        self.Threads = 1
        self.JetJobMode = "optimize"
        self._numsegs = None
        self._traj = None                  # node rows [x, t, u]
        self._odeparams = np.zeros(self.PV)
        self._nlp = None
        self._need_transcribe = True
        self._locks = []            # (spec index, region, var index array)
        self._struct_key = None     # structure signature of the last build
        self._built = None          # [(family, spec or None)] of that build
        if numsegs is not None:
            self.setTraj(IG, numsegs)
        elif IG is not None:
            self.setTraj(IG, max(len(IG) - 1, 4))

    # ------------------------------------------------------------------ mesh
    def _node_structure(self, numsegs, seg_bounds=None):
        """Nodes-per-segment layout and normalized node times.

        seg_bounds: optional (numsegs+1,) non-uniform normalized segment
        boundaries (error-equidistributed meshes from adaptive refinement);
        default uniform."""
        tm = self.TranscriptionMode
        S = int(numsegs)
        cs = {"LGL3": 2, "Trapezoidal": 2, "CentralShooting": 2,
              "LGL5": 3, "LGL7": 4}.get(tm)
        if cs is None:
            raise NotImplementedError(f"transcription mode {tm}")
        self._cs = cs
        self._scheme = get_scheme("LGL3" if cs == 2 else tm)
        self.numSegs = S
        self.numNodes = S * (cs - 1) + 1
        if seg_bounds is None:
            bounds = np.linspace(0.0, 1.0, S + 1)
        else:
            bounds = np.asarray(seg_bounds, np.float64)
            if bounds.shape != (S + 1,):
                raise ValueError(
                    f"seg_bounds must have {S + 1} entries, got "
                    f"{bounds.shape}")
        taus = [0.0]
        for k in range(S):
            a, b = bounds[k], bounds[k + 1]
            for ct in self._scheme.cardinal_tau[1:]:
                taus.append(a + ct * (b - a))
        self.taus = np.asarray(taus)
        self.seg_bounds = bounds
        self.seg_nodes = np.stack([
            np.arange(k * (cs - 1), k * (cs - 1) + cs) for k in range(S)])

    def _seg_consts(self):
        return np.stack([self.seg_bounds[:-1], self.seg_bounds[1:]], axis=1)

    # -------------------------------------------------------- variable layout
    @property
    def _m(self):
        return self.XV + self.UV

    def _xvar(self, node, i):
        return node * self._m + i

    def _uvar(self, node, j):
        if self.ControlMode == ControlModes.BlockConstant:
            cs = self._cs
            node = min(node // (cs - 1), self.numSegs - 1) * (cs - 1)
        return node * self._m + self.XV + j

    @property
    def _t0i(self):
        return self.numNodes * self._m

    @property
    def _tfi(self):
        return self._t0i + 1

    def _opi(self, k):
        return self._tfi + 1 + k

    def _spi(self, k):
        return self._tfi + 1 + self.PV + k

    @property
    def numVars(self):
        return self.numNodes * self._m + 2 + self.PV + self.SPV

    # ------------------------------------------------------------------- IG
    def setTraj(self, IG, numsegs=None, *args, seg_bounds=None):
        # overload setTraj(IG, nsegs, bounds): a non-uniform bounds array
        # may also come positionally
        if args and seg_bounds is None and args[0] is not None \
                and not isinstance(args[0], (bool, int)):
            seg_bounds = np.asarray(args[0], np.float64)
        IG = np.asarray([np.asarray(r, dtype=np.float64).ravel() for r in IG])
        need = self.XV + 1 + self.UV
        if IG.shape[1] < need:
            raise ValueError(
                f"IG rows must have at least {need} entries [x,t,u]")
        if numsegs is None:
            numsegs = self._numsegs or max(len(IG) - 1, 4)
        self._numsegs = int(numsegs)
        self._node_structure(self._numsegs, seg_bounds=seg_bounds)
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

    def refineTrajManual(self, numsegs):
        """Re-mesh the current trajectory onto `numsegs` uniform
        segments."""
        self.resampleTraj(numsegs)

    def refineTrajEqual(self, numsegs):
        self.refineTrajManual(numsegs)

    def resampleTraj(self, numsegs, seg_bounds=None):
        """Re-mesh through the scheme-order interpolant: new node states
        from the degree-(2cs-1) segment Hermite, controls from the
        scheme's Lagrange interpolant, which keeps the solution's
        h^(2cs-2) accuracy across mesh updates (plain setTraj on raw rows
        is linear)."""
        from .interp_table import LGLInterpTable
        if self._traj is None:
            raise ValueError("resampleTraj requires an existing trajectory")
        tab = LGLInterpTable.from_phase(self)
        self._numsegs = int(numsegs)
        self._node_structure(self._numsegs, seg_bounds=seg_bounds)
        ts_new = self.t0 + self.taus * (self.tf - self.t0)
        vals = tab.eval_batch(ts_new)                   # (N, XV+UV)
        rows = np.empty((len(ts_new), self.XV + 1 + self.UV))
        rows[:, :self.XV] = vals[:, :self.XV]
        rows[:, self.XV] = ts_new
        rows[:, self.XV + 1:] = vals[:, self.XV:]
        self._traj = rows
        self._need_transcribe = True

    # ------------------------------------------------------------ params API
    def setStaticParams(self, vals, *args):
        self._static_params = np.asarray(vals, dtype=np.float64).ravel()
        self.SPV = self._static_params.size
        self._need_transcribe = True

    def returnStaticParams(self):
        return self._static_params.copy()

    def setControlMode(self, mode):
        self.ControlMode = str(mode)
        self._need_transcribe = True

    def setThreads(self, *a):
        pass

    def setUnits(self, *a, **kw):
        """Canonical units per XtUP variable, consumed by auto-scaling:
        positional values, one array (e.g. from `ode.make_units`), or
        Vgroup names / indices as keywords."""
        if a and not isinstance(a[0], (int, float)):
            u = np.asarray(a[0], dtype=np.float64).ravel()
        elif a:
            u = np.asarray(a, dtype=np.float64).ravel()
        else:
            u = None
        need = self.XV + 1 + self.UV + self.PV
        if u is not None:
            if u.size < need:
                u = np.concatenate([u, np.ones(need - u.size)])
            self._xtup_units = u[:need]
        if kw:
            units = self._xtup_units
            if units is None:
                units = np.ones(need)
            for name, val in kw.items():
                units[self._resolve_idx(name)] = float(val)
            self._xtup_units = units
        self._units = (a, kw)

    def setAutoScaling(self, flag=True, *a):
        self.AutoScaling = bool(flag)

    def setAdaptiveMesh(self, flag=True, *a):
        self.AdaptiveMesh = bool(flag)

    def setMeshTol(self, tol):
        self.MeshTol = float(tol)

    def setMaxMeshIters(self, n):
        self.MaxMeshIters = int(n)

    def setControlSwitchDetection(self, flag=True, tol=0.1, extra=4):
        self.DetectControlSwitches = bool(flag)
        self.SwitchTol = float(tol)
        self.NumExtraAddsPerSwitch = int(extra)

    def setMeshErrorEstimator(self, est):
        self.MeshErrorEstimator = str(est)

    def setMeshErrorCriteria(self, c):
        self.MeshErrorCriteria = str(c)

    def setMeshErrFactor(self, f):
        self.MeshErrFactor = float(f)

    def setMeshRedFactor(self, f):
        self.MeshRedFactor = float(f)

    def setMeshIncFactor(self, f):
        self.MeshIncFactor = float(f)

    def setMinSegments(self, n):
        self.MinSegments = int(n)

    def setMaxSegments(self, n):
        self.MaxSegments = int(n)

    def PrintMeshInfo(self, *a):
        pass

    @property
    def integrator(self):
        """Phase-owned integrator, available for user stepping."""
        if self._integrator is None:
            from ..Integrators import Integrator
            span = abs(self.tf - self.t0) if self._traj is not None else 1.0
            self._integrator = Integrator(
                self.ode, 0.1 * span / max(self.numSegs, 1))
        return self._integrator

    def setKKTBackend(self, backend):
        """'block' (default): block-tridiagonal BCR; 'dense': the dense
        eigendecomposition backend (small problems, debugging)."""
        backend = str(backend)
        if backend not in ("block", "dense"):
            raise ValueError(f"unknown KKT backend {backend!r}")
        self.KKTBackend = backend
        self._need_transcribe = True
        return self

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

    def _gather_nodes(self, nodes_per_app, segs=None):
        """Vidx rows: [node vars ..., t0, tf, odeparams, staticparams].

        With ControlMode BlockConstant, control slots are rewired to the
        owning segment's block slot; when a family is built per segment
        (`segs` given), all its nodes use that segment's block, including
        the cardinal shared with the next segment."""
        m, XV, UV = self._m, self.XV, self.UV
        nodes = np.asarray(nodes_per_app, np.int64)          # (napps, nn)
        xcols = nodes[:, :, None] * m + np.arange(XV)[None, None, :]
        if self.ControlMode == ControlModes.BlockConstant:
            cs = self._cs
            if segs is not None:
                seg = np.broadcast_to(np.asarray(segs, np.int64)[:, None],
                                      nodes.shape)
            else:
                seg = np.minimum(nodes // (cs - 1), self.numSegs - 1)
            unode = seg * (cs - 1)
        else:
            unode = nodes
        ucols = unode[:, :, None] * m + XV + np.arange(UV)[None, None, :]
        per_node = np.concatenate([xcols, ucols], axis=2)
        tail = np.asarray([self._t0i, self._tfi]
                          + [self._opi(k) for k in range(self.PV)]
                          + [self._spi(k) for k in range(self.SPV)],
                          np.int64)
        return np.concatenate(
            [per_node.reshape(len(nodes), -1),
             np.broadcast_to(tail, (len(nodes), len(tail)))], axis=1)

    def _region_input_fun(self, user_fun, nnodes, with_data=False):
        """Wrap user_fun (input [xtu_1, ..., xtu_k, op, sp]) over the
        gathered variables [nodevars..., t0, tf, op, sp] with node times
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
            parts.append(g[nnodes * m + 2:])   # op ++ sp
            inp = torch.cat(parts)
            if with_data:
                return torch.atleast_1d(user_fun(inp, c[nnodes:]))
            return torch.atleast_1d(user_fun(inp))
        return fun

    def _region_family(self, region, user_fun, name, data=None):
        region = _canon_region(region)
        if region in _PARAM_REGIONS:
            if region == "ODEParams":
                idx = [[self._opi(k) for k in range(self.PV)]]
            else:
                idx = [[self._spi(k) for k in range(self.SPV)]]
            if data is not None:
                fam = IndexedFunction(
                    lambda g, c: torch.atleast_1d(user_fun(g, c)), idx,
                    data[None, :], name=name)
                fam._data_cols = (0, data.size)
                return fam
            return IndexedFunction(
                lambda g, c: torch.atleast_1d(user_fun(g)), idx,
                np.zeros((1, 1)), name=name)
        apps, taus = self._region_apps(region)
        Vidx = self._gather_nodes(apps)
        consts = np.asarray(taus, dtype=np.float64)
        ntau = consts.shape[1]
        if data is not None:
            consts = np.concatenate(
                [consts, np.tile(data, (len(apps), 1))], axis=1)
        fun = self._region_input_fun(user_fun, len(apps[0]),
                                     with_data=data is not None)
        fam = IndexedFunction(fun, Vidx, consts, name=name)
        fam._region = region
        fam._ntau = ntau
        if data is not None:
            fam._data_cols = (ntau, data.size)
        return fam

    def _region_input_width(self, region):
        region = _canon_region(region)
        per = self.XV + 1 + self.UV
        if region == "ODEParams":
            return self.PV
        if region == "StaticParams":
            return self.SPV
        if region in _PAIR_REGIONS:
            return 2 * per
        return per

    # ------------------------------------------------------------- user API
    def _resolve_idx(self, indices):
        """Variable-index arguments: ints, iterables, or Vgroup names."""
        groups = getattr(self.ode, "Vgroups", {}) or {}
        if isinstance(indices, str):
            return np.asarray(groups[indices], dtype=np.int64)
        if isinstance(indices, (int, np.integer)):
            return np.asarray([indices], dtype=np.int64)
        out = []
        for v in indices:
            if isinstance(v, str):
                out.extend(groups[v])
            else:
                out.append(int(v))
        return np.asarray(out, dtype=np.int64)

    def _idx(self, indices):
        """Resolved indices as an index tensor on the problem's device."""
        return config.index(self._resolve_idx(indices), self.device)

    def _add(self, kind, region, fun, nout, name, data=None):
        self._specs.append(_Spec(kind, region, fun, nout, name, data=data))
        self._need_transcribe = True
        return len(self._specs) - 1

    def addEqualCon(self, region, func, *args):
        f, _, orr = self._prep_user_func(region, func, args)
        return self._add("eq", region, f, orr, "user_eq")

    def addInequalCon(self, region, func, *args):
        f, _, orr = self._prep_user_func(region, func, args)
        return self._add("iq", region, f, orr, "user_iq")

    def _prep_user_func(self, region, func, args):
        """Normalize (func, optional index subsets) into a full-region-input
        closure.  Supports the addEqualCon(reg, func, XtUVars[, OPVars,
        SPVars]) subset forms."""
        trace, ir, orr = _tracefun(func)
        width = self._region_input_width(region)
        reg = _canon_region(region)
        if not args:
            if ir != width:
                # a function over [xtu..., op, sp]
                if ir == width + self.PV + self.SPV \
                        and reg not in _PARAM_REGIONS:
                    return trace, ir, orr
                raise ValueError(
                    f"function input size {ir} != region width {width}")
            if reg not in _PARAM_REGIONS:
                return (lambda inp: trace(inp[:width])), ir, orr
            return trace, ir, orr
        # subset index form
        xtuv = self._resolve_idx(args[0])
        opv = np.asarray(args[1], dtype=np.int64).ravel() if len(args) > 1 \
            else np.zeros(0, np.int64)
        spv = np.asarray(args[2], dtype=np.int64).ravel() if len(args) > 2 \
            else np.zeros(0, np.int64)
        per = self.XV + 1 + self.UV
        nnodes = 2 if reg in _PAIR_REGIONS else 1
        sel = np.concatenate([xtuv, nnodes * per + opv,
                              nnodes * per + self.PV + spv]).astype(np.int64)
        if len(sel) != ir:
            raise ValueError(
                f"selected {len(sel)} vars but function takes {ir}")
        selt = config.index(sel, self.device)
        return (lambda inp: trace(inp[selt])), ir, orr

    # boundary values / locks ----------------------------------------------
    def addBoundaryValue(self, region, indices, values):
        idx = self._idx(indices)
        vals = np.asarray(values, dtype=np.float64).ravel()

        def fun(inp, d):
            return inp[idx] - d
        si = self._add("eq", region, fun, int(idx.shape[0]), "boundary",
                       data=vals)
        self._locks.append((si, _canon_region(region),
                            self._resolve_idx(indices)))
        return si

    def addValueLock(self, region, indices):
        """Pin variables to their current values; update the pinned values
        later with subVariables, without re-transcription."""
        return self.addBoundaryValue(region, indices,
                                     self._values_at_region(region, indices))

    def subVariables(self, region, indices, values):
        """Substitute new values for variables pinned by addValueLock /
        addBoundaryValue in `region`: updates the lock targets and the
        trajectory, so the next solve starts consistent."""
        region = _canon_region(region)
        idx = self._resolve_idx(indices)
        values = np.asarray(values, np.float64).ravel()
        hit = None
        for si, reg, lidx in self._locks:
            if reg != region:
                continue
            pos = {int(v): k for k, v in enumerate(lidx)}
            sel = [pos[int(v)] for v in idx if int(v) in pos]
            if len(sel) != len(idx):
                continue
            self._specs[si].data[np.asarray(sel)] = values
            hit = si
            break
        if hit is None:
            raise ValueError(
                f"subVariables: no value lock covering {region} {idx}")
        if region == "StaticParams":
            self._static_params[idx] = values
        elif region == "ODEParams":
            self._odeparams[idx] = values
        else:
            row = {"Front": 0, "Back": self.numNodes - 1}.get(region)
            if row is not None and self._traj is not None:
                per = self.XV + 1 + self.UV
                for v, val in zip(idx, values):
                    if v < per:
                        self._traj[row, v] = val
                        if v == self.XV:  # time variable
                            if row == 0:
                                self.t0 = float(val)
                            else:
                                self.tf = float(val)
        self._push_spec_data(hit)

    def subVariable(self, region, index, value):
        return self.subVariables(region, [index], [value])

    def _push_spec_data(self, si):
        """Propagate an updated spec.data into the live family consts (if
        transcribed) and refresh the NLP's device consts.  Works for a
        phase-owned and an OCP-owned NLP (the OCP's shifted families share
        the phase families' consts arrays)."""
        nlp = getattr(self, "_active_nlp", None) or self._nlp
        if self._built is None or nlp is None:
            return
        spec = self._specs[si]
        for fam, sp in self._built:
            if sp is spec and getattr(fam, "_data_cols", None) is not None:
                lo, nd = fam._data_cols
                fam.consts[:, lo:lo + nd] = spec.data[None, :]
        nlp.bump_consts()

    def addPeriodicityCon(self, indices):
        idx = config.index(np.asarray(indices, np.int64).ravel(),
                           self.device)
        per = self.XV + 1 + self.UV

        def fun(inp):
            return inp[idx] - inp[idx + per]
        return self._add("eq", "FrontandBack", fun, int(idx.shape[0]),
                         "periodicity")

    def _values_at_region(self, region, indices):
        region = _canon_region(region)
        idx = np.asarray(indices, dtype=np.int64)
        if region == "StaticParams":
            return self._static_params[idx]
        if region == "ODEParams":
            return self._odeparams[idx]
        row = {"Front": 0, "Back": self.numNodes - 1}.get(region)
        if row is None:
            raise ValueError(
                "addValueLock supports Front/Back/StaticParams/ODEParams")
        return self._traj[0 if row == 0 else -1][idx]

    # bounds ---------------------------------------------------------------
    def _one_var(self, var):
        if isinstance(var, str):
            return int(self._resolve_idx(var)[0])
        return int(var)

    def addLUVarBound(self, region, var, lb, ub, scale=1.0):
        if not isinstance(var, (int, np.integer)):
            resolved = self._resolve_idx(var)
            if len(resolved) > 1:
                return self.addLUVarBounds(region, resolved, lb, ub, scale)
            var = int(resolved[0])
        var = int(var)
        lb, ub, s = float(lb), float(ub), float(scale)

        def fun(inp):
            v = inp[var]
            return torch.stack([(lb - v) * s, (v - ub) * s])
        return self._add("iq", region, fun, 2, "luvarbound")

    def addLUVarBounds(self, region, varlist, lb, ub, scale=1.0):
        return [self.addLUVarBound(region, int(v), lb, ub, scale)
                for v in self._resolve_idx(varlist)]

    def addLowerVarBound(self, region, var, lb, scale=1.0):
        var, lb, s = self._one_var(var), float(lb), float(scale)

        def fun(inp):
            return ((lb - inp[var]) * s)[None]
        return self._add("iq", region, fun, 1, "lowerbound")

    def addUpperVarBound(self, region, var, ub, scale=1.0):
        var, ub, s = self._one_var(var), float(ub), float(scale)

        def fun(inp):
            return ((inp[var] - ub) * s)[None]
        return self._add("iq", region, fun, 1, "upperbound")

    def addLUFuncBound(self, region, func, indices, lb, ub, scale=1.0):
        trace, _, orr = _tracefun(func)
        if orr != 1:
            raise ValueError("func bound requires scalar function")
        idx = self._idx(indices)
        lb, ub, s = float(lb), float(ub), float(scale)

        def fun(inp):
            v = trace(inp[idx])[0]
            return torch.stack([(lb - v) * s, (v - ub) * s])
        return self._add("iq", region, fun, 2, "lufuncbound")

    def addLowerFuncBound(self, region, func, indices, lb, scale=1.0):
        trace, _, _ = _tracefun(func)
        idx = self._idx(indices)
        lb, s = float(lb), float(scale)

        def fun(inp):
            return (lb - trace(inp[idx])[0])[None] * s
        return self._add("iq", region, fun, 1, "lowerfuncbound")

    def addUpperFuncBound(self, region, func, indices, ub, scale=1.0):
        trace, _, _ = _tracefun(func)
        idx = self._idx(indices)
        ub, s = float(ub), float(scale)

        def fun(inp):
            return (trace(inp[idx])[0] - ub)[None] * s
        return self._add("iq", region, fun, 1, "upperfuncbound")

    def addLUNormBound(self, region, indices, lb, ub, scale=1.0):
        idx = self._idx(indices)
        lb, ub, s = float(lb), float(ub), float(scale)

        def fun(inp):
            nv = torch.sqrt(torch.sum(torch.square(inp[idx])))
            return torch.stack([(lb - nv) * s, (nv - ub) * s])
        return self._add("iq", region, fun, 2, "lunormbound")

    def addLowerNormBound(self, region, indices, lb, scale=1.0):
        idx = self._idx(indices)
        lb, s = float(lb), float(scale)

        def fun(inp):
            nv = torch.sqrt(torch.sum(torch.square(inp[idx])))
            return ((lb - nv) * s)[None]
        return self._add("iq", region, fun, 1, "lowernormbound")

    def addUpperNormBound(self, region, indices, ub, scale=1.0):
        idx = self._idx(indices)
        ub, s = float(ub), float(scale)

        def fun(inp):
            nv = torch.sqrt(torch.sum(torch.square(inp[idx])))
            return ((nv - ub) * s)[None]
        return self._add("iq", region, fun, 1, "uppernormbound")

    def addLUSquaredNormBound(self, region, indices, lb, ub, scale=1.0):
        idx = self._idx(indices)
        lb, ub, s = float(lb), float(ub), float(scale)

        def fun(inp):
            nv = torch.sum(torch.square(inp[idx]))
            return torch.stack([(lb - nv) * s, (nv - ub) * s])
        return self._add("iq", region, fun, 2, "lusqnormbound")

    def addUpperDeltaTimeBound(self, ub, scale=1.0):
        ub, s = float(ub), float(scale)
        per, tv = self.XV + 1 + self.UV, self.XV

        def fun(inp):
            return ((inp[per + tv] - inp[tv] - ub) * s)[None]
        return self._add("iq", "FrontandBack", fun, 1, "upperdtbound")

    def addLowerDeltaTimeBound(self, lb, scale=1.0):
        lb, s = float(lb), float(scale)
        per, tv = self.XV + 1 + self.UV, self.XV

        def fun(inp):
            return ((lb - (inp[per + tv] - inp[tv])) * s)[None]
        return self._add("iq", "FrontandBack", fun, 1, "lowerdtbound")

    def addDeltaVarEqualCon(self, var, value, scale=1.0):
        var, value, s = int(var), float(value), float(scale)
        per = self.XV + 1 + self.UV

        def fun(inp):
            return ((inp[per + var] - inp[var] - value) * s)[None]
        return self._add("eq", "FrontandBack", fun, 1, "deltavareq")

    def addDeltaTimeEqualCon(self, value, scale=1.0):
        return self.addDeltaVarEqualCon(self.XV, value, scale)

    # objectives -----------------------------------------------------------
    def addValueObjective(self, region, var, scale=1.0):
        var, s = self._one_var(var), float(scale)

        def fun(inp):
            return (inp[var] * s)[None]
        return self._add("obj", region, fun, 1, "valueobj")

    def addStateObjective(self, region, func, *args):
        f, _, orr = self._prep_user_func(region, func, args)
        if orr != 1:
            raise ValueError("objective must be scalar")
        return self._add("obj", region, f, 1, "stateobj")

    def addDeltaVarObjective(self, var, scale=1.0):
        var, s = self._one_var(var), float(scale)
        per = self.XV + 1 + self.UV

        def fun(inp):
            return ((inp[per + var] - inp[var]) * s)[None]
        return self._add("obj", "FrontandBack", fun, 1, "deltavarobj")

    def addDeltaTimeObjective(self, scale=1.0):
        return self.addDeltaVarObjective(self.XV, scale)

    def addIntegralObjective(self, func, indices, *args):
        trace, ir, orr = _tracefun(func)
        if orr != 1:
            raise ValueError("integral objective must be scalar")
        idx = self._resolve_idx(indices)
        if len(idx) != ir:
            raise ValueError("index list width != function input size")
        return self._add("intobj", "Integral", (trace, idx), 1, "intobj")

    def addIntegralParamFunction(self, func, indices, pnum):
        """Accumulate an integral into static parameter pnum, as the
        equality  sum over segments of quad(f) - sp[pnum] = 0."""
        trace, _, _ = _tracefun(func)
        idx = np.asarray(indices, dtype=np.int64).ravel()
        return self._add("inteq", "Integral", (trace, idx, int(pnum)), 1,
                         "intparam")

    def removeStateObjective(self, which=-1):
        self._remove_kind("obj", which)

    def removeIntegralObjective(self, which=-1):
        self._remove_kind("intobj", which)

    def removeEqualCon(self, which=-1):
        self._remove_kind("eq", which)

    def _remove_kind(self, kind, which):
        idxs = [i for i, s in enumerate(self._specs) if s.kind == kind]
        if not idxs:
            return
        del self._specs[idxs[which]]
        self._need_transcribe = True

    # ------------------------------------------------------------ transcribe
    def _seg_apps(self):
        return [tuple(self.seg_nodes[k]) for k in range(self.numSegs)]

    def _defect_family(self):
        """Hermite-LGL defects (LGL3/5/7), trapezoidal defects, or the
        central-shooting family, one application per segment."""
        if self.TranscriptionMode == "CentralShooting":
            return self._shooting_family()
        cs = self._cs
        sch = self._scheme
        XV, PV = self.XV, self.PV
        m = self._m
        ode_rhs = self.ode.vf().trace
        trap = self.TranscriptionMode == "Trapezoidal"
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
            if trap:
                return xs[0] - xs[1] + 0.5 * h * (fs[0] + fs[1])
            x_i = x_int @ xs + h * (dx_int @ fs)        # (cs-1, XV)
            u_i = u_int @ us                            # (cs-1, UV)
            t_i = t0 + (c[0] + itau * dtau) * T
            f_i = torch.stack([
                ode_rhs(torch.cat([x_i[i], t_i[i][None], u_i[i], p]))
                for i in range(cs - 1)])
            d = x_def @ xs + h * (dx_def @ fs) + h * (i_def[:, None] * f_i)
            return d.reshape(-1)

        Vidx = self._gather_nodes(self._seg_apps(),
                                  segs=list(range(self.numSegs)))
        return IndexedFunction(fun, Vidx, self._seg_consts(), name="defects")

    def _shooting_family(self):
        """Central-shooting defects: fixed-step RK4 forward from the
        segment start and backward from the segment end meet at the
        midpoint.  Controls are linear in local time between the segment's
        nodes."""
        XV, PV = self.XV, self.PV
        m = self._m
        ode_rhs = self.ode.vf().trace
        nsub = int(getattr(self, "ShooterSubSteps", 4))

        def rk4_span(x, u0, u1, t0, h, p, nsteps):
            # nsteps of RK4 over [t0, t0 + h*nsteps]; control linear from
            # u0 (local 0) to u1 (local 1) over the half span
            def f(xx, tt, s_loc):
                u = u0 * (1.0 - s_loc) + u1 * s_loc
                return ode_rhs(torch.cat([xx, tt[None], u, p]))
            for i in range(nsteps):
                t = t0 + i * h
                s0 = i / nsteps
                sh = (i + 0.5) / nsteps
                s1 = (i + 1.0) / nsteps
                k1 = f(x, t, s0)
                k2 = f(x + 0.5 * h * k1, t + 0.5 * h, sh)
                k3 = f(x + 0.5 * h * k2, t + 0.5 * h, sh)
                k4 = f(x + h * k3, t + h, s1)
                x = x + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            return x

        def fun(g, c):
            t0g = g[2 * m]
            tfg = g[2 * m + 1]
            p = g[2 * m + 2:2 * m + 2 + PV]
            T = tfg - t0g
            dtau = c[1] - c[0]
            hseg = dtau * T
            ta = t0g + c[0] * T
            tb = t0g + c[1] * T
            xa, ua = g[0:XV], g[XV:m]
            xb, ub = g[m:m + XV], g[m + XV:2 * m]
            nh = max(nsub // 2, 1)
            hf = 0.5 * hseg / nh
            umid = 0.5 * (ua + ub)
            xf_mid = rk4_span(xa, ua, umid, ta, hf, p, nh)
            xb_mid = rk4_span(xb, ub, umid, tb, -hf, p, nh)
            return xf_mid - xb_mid

        Vidx = self._gather_nodes(self._seg_apps(),
                                  segs=list(range(self.numSegs)))
        return IndexedFunction(fun, Vidx, self._seg_consts(),
                               name="shooting")

    def _control_families(self):
        """Control regularity constraints per ControlMode."""
        cs, UV, m, XV = self._cs, self.UV, self._m, self.XV
        if UV == 0 or self.TranscriptionMode == "Trapezoidal":
            return []
        mode = self.ControlMode
        if mode == ControlModes.BlockConstant:
            # pin the orphaned per-node control slots (their gathers are
            # rewired to the segment's block slot) to keep the KKT
            # nonsingular
            orphan = [i for i in range(self.numNodes)
                      if not (i % (cs - 1) == 0
                              and i // (cs - 1) < self.numSegs)]
            if not orphan:
                return []
            rows = np.asarray(orphan, np.int64)[:, None] * m + XV \
                + np.arange(UV)[None, :]
            return [IndexedFunction(lambda g, c: g, rows,
                                    np.zeros((len(orphan), 1)),
                                    name="blockpin")]
        if cs == 2 or mode == ControlModes.NoSpline:
            return []
        sch = self._scheme
        if mode == ControlModes.FirstOrderSpline:
            # interior cardinal controls = linear interpolation of the
            # segment's end controls
            ct = sch.cardinal_tau
            w = config.tensor([[1.0 - ct[j], ct[j]] for j in range(1, cs - 1)],
                              self.device)

            def fun(g, c):
                us = torch.stack([g[j * m + XV:(j + 1) * m]
                                  for j in range(cs)])
                lin = w @ torch.stack([us[0], us[-1]])
                return (us[1:cs - 1] - lin).reshape(-1)
            return [IndexedFunction(fun, self._gather_nodes(self._seg_apps()),
                                    self._seg_consts(), name="uspline1")]
        if mode == ControlModes.HighestOrderSpline:
            # derivative continuity across segment junctions
            d0 = config.tensor(sch.u_dtau0, self.device)
            d1 = config.tensor(sch.u_dtau1, self.device)
            nn = 2 * cs - 1

            def fun(g, c):
                # g: two adjacent segments' nodes (2*cs-1 distinct nodes)
                t0 = g[nn * m]
                tf = g[nn * m + 1]
                T = tf - t0
                h0 = (c[1] - c[0]) * T
                h1 = (c[2] - c[1]) * T
                usA = torch.stack([g[j * m + XV:(j + 1) * m]
                                   for j in range(cs)])
                usB = torch.stack([g[j * m + XV:(j + 1) * m]
                                   for j in range(cs - 1, nn)])
                return ((d1 @ usA) / h0 - (d0 @ usB) / h1).reshape(-1)
            S = self.numSegs
            if S < 2:
                return []
            apps = [tuple(self.seg_nodes[k]) + tuple(self.seg_nodes[k + 1][1:])
                    for k in range(S - 1)]
            consts = np.stack([self.seg_bounds[:-2], self.seg_bounds[1:-1],
                               self.seg_bounds[2:]], axis=1)
            return [IndexedFunction(fun, self._gather_nodes(apps), consts,
                                    name="usplineH")]
        return []

    def _integral_family(self, trace, idx, extra_sp=None):
        """Per-segment quadrature family with the reduced (cardinal-only)
        weights.  extra_sp: the static parameter an integral equality
        (addIntegralParamFunction) accumulates into."""
        cs, m, XV, PV = self._cs, self._m, self.XV, self.PV
        sch = self._scheme
        wq = config.tensor(sch.quad_reduced, self.device)
        ctau = [float(t) for t in sch.cardinal_tau]
        idxj = config.index(idx, self.device)
        spsel = None if extra_sp is None else int(extra_sp)

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
            integ = h * (wq @ torch.stack(vals))
            if spsel is not None:
                # equality: this segment's share minus sp / numSegs
                sp = g[cs * m + 2 + PV + spsel]
                return (integ - sp * c[2])[None]
            return integ[None]

        consts = self._seg_consts()
        if spsel is not None:
            consts = np.concatenate(
                [consts, np.full((self.numSegs, 1), 1.0 / self.numSegs)],
                axis=1)
        Vidx = self._gather_nodes(self._seg_apps(),
                                  segs=list(range(self.numSegs)))
        return IndexedFunction(fun, Vidx, consts, name="integral")

    def var_units(self):
        """(numVars,) canonical unit per phase variable (1 = unscaled)."""
        units = self._xtup_units
        if units is None:
            units = np.ones(self.XV + 1 + self.UV + self.PV)
        XV, UV, m = self.XV, self.UV, self._m
        U = np.ones(self.numVars)
        nodes = U[:self.numNodes * m].reshape(self.numNodes, m)
        nodes[:, :XV] = units[:XV]
        nodes[:, XV:] = units[XV + 1:XV + 1 + UV]
        U[self._t0i] = U[self._tfi] = units[XV]
        for k in range(self.PV):
            U[self._opi(k)] = units[XV + 1 + UV + k]
        return U

    def _apply_autoscale(self, eqs, iqs, objs):
        """Scale variables by their units and constraint rows by the
        probed mean norm of the unit-scaled Jacobian row (each family's
        Jacobian is evaluated once at the raw input, on the problem's
        device); the objectives share one synchronized scale."""
        U = self.var_units()
        self._scale_vec = U
        V0 = config.tensor(self.makeSolverInput(raw=True), self.device)

        def row_scales(fam):
            _, jx = _family_valjac(fam.fun)(
                V0[config.index(fam.Vidx, self.device)],
                config.tensor(fam.consts, self.device))
            rown = np.linalg.norm(
                jx.cpu().numpy() * U[fam.Vidx][:, None, :], axis=2)
            return 1.0 / np.clip(rown.mean(axis=0), 1e-8, 1e8)

        def rescale(fam, rs):
            out = IndexedFunction(
                fam.fun, fam.Vidx, fam.consts, name=fam.name,
                in_scales=U[fam.Vidx],
                out_scales=np.broadcast_to(rs, (fam.napps, fam.nout)))
            # the scaling wrapper appends its columns after the original
            # consts, so taus and data columns keep their position
            for attr in ("_data_cols", "_region", "_ntau"):
                if getattr(fam, attr, None) is not None:
                    setattr(out, attr, getattr(fam, attr))
            return out

        eqs2 = [rescale(f, row_scales(f)) for f in eqs]
        iqs2 = [rescale(f, row_scales(f)) for f in iqs]
        self._obj_scale = 1.0
        if objs:
            self._obj_scale = float(np.mean([row_scales(f)[0]
                                             for f in objs]))
            objs = [rescale(f, np.full(1, self._obj_scale)) for f in objs]
        return eqs2, iqs2, objs

    def _build_families(self):
        """(eqs, iqs, objs) IndexedFunction lists in phase-local indices;
        records [(family, spec or None)] for the consts refresh."""
        eqs = [self._defect_family()] + self._control_families()
        eq_specs = [None] * len(eqs)
        iqs, objs, iq_specs, obj_specs = [], [], [], []
        for spec in self._specs:
            if spec.kind == "intobj":
                objs.append(self._integral_family(*spec.fun))
                obj_specs.append(spec)
            elif spec.kind == "inteq":
                eqs.append(self._integral_family(*spec.fun))
                eq_specs.append(spec)
            else:
                fam = self._region_family(spec.region, spec.fun, spec.name,
                                          data=spec.data)
                {"obj": objs, "eq": eqs, "iq": iqs}[spec.kind].append(fam)
                {"obj": obj_specs, "eq": eq_specs,
                 "iq": iq_specs}[spec.kind].append(spec)
        if self.AutoScaling:
            eqs, iqs, objs = self._apply_autoscale(eqs, iqs, objs)
        else:
            self._scale_vec = self._obj_scale = None
        self._built = list(zip(eqs + iqs + objs,
                               eq_specs + iq_specs + obj_specs))
        return eqs, iqs, objs

    def node_of_var(self):
        """Node id per phase variable (-1 = border: t0, tf, params): the
        structure map of the block-tridiagonal KKT backend."""
        nov = np.full(self.numVars, -1, np.int64)
        m = self._m
        nov[:self.numNodes * m] = np.arange(self.numNodes * m) // m
        return nov

    def _structure_key(self):
        return (self._numsegs, self.TranscriptionMode, self.ControlMode,
                self.AutoScaling, self.SPV, self.PV, self.KKTBackend,
                tuple(id(s) for s in self._specs))

    def _refresh_consts(self, nlp=None):
        """Re-transcription without rebuilding: with the structure
        unchanged, only the consts (mesh fractions, lock and boundary
        data) are refreshed."""
        segc2 = self._seg_consts()
        for fam, spec in self._built:
            if fam.name in ("defects", "shooting", "uspline1", "integral"):
                fam.consts[:, :2] = segc2
                if fam.name == "integral" and spec is not None \
                        and spec.kind == "inteq":
                    fam.consts[:, 2] = 1.0 / self.numSegs
            elif fam.name == "usplineH":
                fam.consts[:, 0] = self.seg_bounds[:-2]
                fam.consts[:, 1] = self.seg_bounds[1:-1]
                fam.consts[:, 2] = self.seg_bounds[2:]
            elif getattr(fam, "_region", None) is not None:
                _, taus = self._region_apps(fam._region)
                fam.consts[:, :fam._ntau] = np.asarray(taus, np.float64)
            if spec is not None and spec.data is not None \
                    and getattr(fam, "_data_cols", None) is not None:
                lo, nd = fam._data_cols
                fam.consts[:, lo:lo + nd] = spec.data[None, :]
        (nlp or self._nlp).bump_consts()

    def transcribe(self, *_):
        key = self._structure_key()
        if self._nlp is not None and key == self._struct_key:
            self._refresh_consts()
            self._need_transcribe = False
            return
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
        kkt = None
        if self.KKTBackend == "block":
            from ..Solvers.kkt_block import BlockKKT
            try:
                kkt = BlockKKT(nlp, self.node_of_var(),
                               x0=self.makeSolverInput())
            except ValueError as e:
                # a structure the block backend cannot hold (e.g. nonlinear
                # front-to-back coupling): PSIOPT builds the dense backend
                if self.optimizer.PrintLevel <= 1:
                    print(f"  [kkt] falling back to dense backend: {e}")
        self.optimizer.setNLP(nlp, kkt)
        self._struct_key = key
        self._active_nlp = nlp
        self._need_transcribe = False

    # --------------------------------------------------------- solve entries
    def makeSolverInput(self, raw=False):
        """The solver's variable vector of the current trajectory, in
        scaled variables when auto-scaling is on (raw: always physical)."""
        m = self._m
        V = np.zeros(self.numVars)
        nodes = V[:self.numNodes * m].reshape(self.numNodes, m)
        nodes[:, :self.XV] = self._traj[:, :self.XV]
        nodes[:, self.XV:] = self._traj[:, self.XV + 1:]
        V[self._t0i] = self.t0
        V[self._tfi] = self.tf
        for k in range(self.PV):
            V[self._opi(k)] = self._odeparams[k]
        for k in range(self.SPV):
            V[self._spi(k)] = self._static_params[k]
        if not raw and self._scale_vec is not None:
            V = V / self._scale_vec
        return V

    def collectSolverOutput(self, V):
        V = np.asarray(V, np.float64)
        if self._scale_vec is not None:
            V = V * self._scale_vec
        m = self._m
        self.t0 = float(V[self._t0i])
        self.tf = float(V[self._tfi])
        nodes = V[:self.numNodes * m].reshape(self.numNodes, m)
        traj = np.empty((self.numNodes, self.XV + 1 + self.UV))
        traj[:, :self.XV] = nodes[:, :self.XV]
        traj[:, self.XV] = self.t0 + self.taus * (self.tf - self.t0)
        traj[:, self.XV + 1:] = nodes[:, self.XV:]
        if self.ControlMode == ControlModes.BlockConstant:
            for i in range(self.numNodes):
                u0 = self._uvar(i, 0)
                traj[i, self.XV + 1:] = V[u0:u0 + self.UV]
        self._traj = traj
        for k in range(self.PV):
            self._odeparams[k] = V[self._opi(k)]
        if self.SPV:
            self._static_params = np.array(
                [V[self._spi(k)] for k in range(self.SPV)])

    def _psipot_call(self, method):
        if self._need_transcribe or self._nlp is None:
            self.transcribe()
        V = getattr(self.optimizer, method)(self.makeSolverInput())
        self.collectSolverOutput(V)
        if self._obj_scale:
            # report the physical objective (rows run scaled internally)
            self.optimizer.LastObjVal /= self._obj_scale
        return self.optimizer.ConvergeFlag

    def _mesh_call(self, method):
        flag = self._psipot_call(method)
        if not self.AdaptiveMesh:
            return flag
        from .mesh import adaptive_mesh_loop
        return adaptive_mesh_loop(self, method, flag)

    def optimize(self):
        return self._mesh_call("optimize")

    def solve(self):
        return self._mesh_call("solve")

    def solve_optimize(self):
        return self._mesh_call("solve_optimize")

    def solve_optimize_solve(self):
        return self._mesh_call("solve_optimize_solve")

    def optimize_solve(self):
        return self._mesh_call("optimize_solve")

    def jet_run(self):
        mode = str(self.JetJobMode).lower().replace("_", "")
        canon = {"optimize": "optimize", "solve": "solve",
                 "solveoptimize": "solve_optimize",
                 "optimizesolve": "optimize_solve",
                 "solveoptimizesolve": "solve_optimize_solve"}
        return self._mesh_call(canon.get(mode, "optimize"))

    # ----------------------------------------------------------- extraction
    def returnTraj(self):
        out = self._traj.copy()
        if self.PV > 0:
            out = np.hstack([out, np.tile(self._odeparams,
                                          (out.shape[0], 1))])
        return [row.copy() for row in out]

    def returnTrajTable(self):
        """Scheme-order interpolation table of the current trajectory."""
        from .interp_table import LGLInterpTable
        return LGLInterpTable.from_phase(self)

    def returnTrajError(self):
        from .mesh import trajectory_error
        return trajectory_error(self)

    def returnCostateTraj(self):
        """Costate estimate from the defect multipliers: the defect rows
        carry the w_i*h quadrature scaling, so the raw multiplier of
        interior collocation point i is the costate at t_i; the samples at
        the interior times are linearly interpolated (extrapolated at the
        phase ends) onto the cardinal node times.  Rows are [costates,
        t]."""
        lam = self.optimizer.LastEqLmults
        if lam is None:
            raise RuntimeError("no multipliers: solve first")
        cs = self._cs
        trap = self.TranscriptionMode == "Trapezoidal"
        nI = 1 if trap else cs - 1
        S = self.numSegs
        # the defect family comes first among the equality rows
        lam_def = lam[:S * nI * self.XV].reshape(S, nI, self.XV)
        T = self.tf - self.t0
        # interior collocation times per segment (trapezoidal: midpoint)
        itau = np.array([0.5]) if trap else \
            np.asarray(self._scheme.interior_tau)
        a = self.seg_bounds[:-1][:, None]
        dtau = np.diff(self.seg_bounds)[:, None]
        pts_t = (self.t0 + (a + itau[None, :] * dtau) * T).ravel()
        pts_l = lam_def.reshape(S * nI, self.XV)
        ts = self.t0 + self.taus * T
        if len(pts_t) == 1:
            cost = np.broadcast_to(pts_l, (self.numNodes, self.XV)).copy()
        else:
            i1 = np.clip(np.searchsorted(pts_t, ts), 1, len(pts_t) - 1)
            i0 = i1 - 1
            w = ((ts - pts_t[i0]) / (pts_t[i1] - pts_t[i0]))[:, None]
            cost = pts_l[i0] + w * (pts_l[i1] - pts_l[i0])
        return [np.concatenate([cost[i], [ts[i]]])
                for i in range(self.numNodes)]
