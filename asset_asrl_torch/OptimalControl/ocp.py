"""OptimalControlProblem: multi-phase container with link constraints.

Port of `asset_asrl_tpu/OptimalControl/ocp.py`.  One flat variable vector
[phase0 vars | phase1 vars | ... | link params]; phases couple only
through link rows.  For the block KKT the phases are consecutive spans of
one global node chain: forward links couple adjacent nodes and stay in
the band, while Path-to-Path and other long-range links go to the dense
border.  Auto-scaled phases expose scaled variables, so the link families
multiply them by the global unit vector and see physical values.  With
`setAdaptiveMesh(True)` every solve is followed by the multi-phase mesh
loop: estimate each phase's error, refine the failing phases,
re-transcribe the whole problem, re-solve.

Not ported: the sharded KKT backend.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..Solvers.nlp import NonLinearProgram, IndexedFunction
from ..Solvers.psiopt import PSIOPT
from ..Utils import span
from ..VectorFunctions.function import Arguments
from .phase import Phase, _canon_region, _tracefun

__all__ = ["OptimalControlProblem", "LinkFlags"]


class LinkFlags:
    BackToFront = "BackToFront"
    FrontToBack = "FrontToBack"
    FrontToFront = "FrontToFront"
    BackToBack = "BackToBack"
    LinkParams = "LinkParams"
    PathToPath = "PathToPath"


_PATH = ("Path", "InnerPath")
# profiler ranges (`Utils.span`) of a solve's host work outside PSIOPT
_TRANSCRIBE = "asset.ocp.transcribe"
_IO = "asset.ocp.io"


class OptimalControlProblem:

    def __init__(self):
        self.Phases: list[Phase] = []
        self._phase_names = {}
        self.optimizer = PSIOPT()
        self.device = config.DEVICE
        self.KKTBackend = "block"
        self.KKTMesh = None
        self.KKTAxis = "seg"
        self._link_params = np.zeros(0)
        self._link_specs = []
        self._nlp = None
        self._ocp_struct_key = None
        self.AdaptiveMesh = False
        self.Threads = 1
        self.JetJobMode = "optimize"
        self.LastSolveStats = None

    # ----------------------------------------------------------- phase admin
    def addPhase(self, phase, name=None):
        self.Phases.append(phase)
        if name is not None:
            self._phase_names[name] = phase
        return phase

    def addPhases(self, phases):
        for p in phases:
            self.addPhase(p)
        return phases

    def removePhase(self, which):
        self.Phases.remove(self._phase(which))

    def Phase(self, i):
        return self._phase(i)

    def _phase(self, p):
        if isinstance(p, Phase):
            return p
        if isinstance(p, str):
            return self._phase_names[p]
        return self.Phases[int(p)]

    def _phase_index(self, p):
        return self.Phases.index(self._phase(p))

    # ------------------------------------------------------------ link params
    def setLinkParams(self, vals):
        self._link_params = np.asarray(vals, dtype=np.float64).ravel()

    def returnLinkParams(self):
        return self._link_params.copy()

    # ----------------------------------------------------------- link builder
    def _boundary_gather(self, phase, offset, which):
        """Global indices + tau of one phase boundary: [node vars, t0, tf,
        op, sp] shifted by the phase's offset."""
        node = 0 if which == "Front" else phase.numNodes - 1
        tau = 0.0 if which == "Front" else 1.0
        m = phase._m
        idx = [offset + node * m + i for i in range(m)]
        idx += [offset + phase._t0i, offset + phase._tfi]
        idx += [offset + phase._opi(k) for k in range(phase.PV)]
        idx += [offset + phase._spi(k) for k in range(phase.SPV)]
        return idx, tau

    @staticmethod
    def _boundary_input(phase, g, lo, tau):
        """[x, t, u, op ++ sp] of one phase boundary from the gathered g
        starting at lo."""
        m, XV = phase._m, phase.XV
        x = g[lo:lo + XV]
        u = g[lo + XV:lo + m]
        t0 = g[lo + m]
        tf = g[lo + m + 1]
        t = t0 * (1.0 - tau) + tf * tau
        rest = g[lo + m + 2:lo + m + 2 + phase.PV + phase.SPV]
        return [x, t[None], u, rest]

    def _ix(self, a):
        return config.index(np.asarray(a, np.int64).ravel(), self.device)

    # ------------------------------------------------------------- link API
    def addForwardLinkEqualCon(self, p0, p1, vars_):
        """Continuity chain: for each consecutive phase pair from p0 to p1,
        back vars == front vars for the XtU indices `vars_`."""
        i0 = self._phase_index(p0)
        i1 = self._phase_index(p1)
        vars_ = list(self.Phases[i0]._resolve_idx(vars_))
        for k in range(i0, i1):
            self.addDirectLinkEqualCon(k, "Back", vars_, k + 1, "Front",
                                       vars_)
        return len(self._link_specs) - 1

    def addDirectLinkEqualCon(self, *args):
        """addDirectLinkEqualCon(p0, reg0, vars0, p1, reg1, vars1) or
        (func, p0, reg0, vars0, p1, reg1, vars1)."""
        if len(args) == 6:
            pa, ra, va, pb, rb, vb = args
            func = None
        elif len(args) == 7:
            func, pa, ra, va, pb, rb, vb = args
        else:
            raise TypeError("addDirectLinkEqualCon: bad arguments")
        self._link_specs.append(
            ("direct", func, self._phase(pa), _canon_region(ra),
             np.asarray(list(va), np.int64),
             self._phase(pb), _canon_region(rb),
             np.asarray(list(vb), np.int64)))
        return len(self._link_specs) - 1

    def addLinkEqualCon(self, func, *args):
        """General link constraint over regions of several phases:

        * addLinkEqualCon(func, [(phase, region), ...])
        * addLinkEqualCon(func, phase0, reg0, phase1, reg1, ...)
        * addLinkEqualCon(func, [(phase, region, XtUVars, OPVars, SPVars),
          ...], LinkParams): the function input is the concatenation of
          each tuple's selected variables, then the selected link
          parameters.
        """
        if len(args) >= 1 and isinstance(args[0], (list, tuple)) and \
                len(args[0]) and isinstance(args[0][0], (list, tuple)) and \
                len(args[0][0]) >= 3:
            sel = []
            for tup in args[0]:
                sets = [np.asarray(list(tup[k]), np.int64) if len(tup) > k
                        else np.zeros(0, np.int64) for k in (2, 3, 4)]
                sel.append((self._phase(tup[0]), _canon_region(tup[1]),
                            *sets))
            lp = np.asarray(list(args[1]), np.int64) if len(args) > 1 \
                else np.zeros(0, np.int64)
            self._link_specs.append(("general_idx", func, sel, lp))
            return len(self._link_specs) - 1
        self._link_specs.append(("general", func, self._pairs(args)))
        return len(self._link_specs) - 1

    def _pairs(self, args):
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            return [(self._phase(p), _canon_region(r)) for p, r in args[0]]
        return [(self._phase(args[i]), _canon_region(args[i + 1]))
                for i in range(0, len(args), 2)]

    def addLinkParamEqualCon(self, func, pidx):
        """Equality on the link params selected by pidx."""
        self._link_specs.append(
            ("linkparams", func, np.asarray(list(pidx), np.int64)))
        return len(self._link_specs) - 1

    def addLinkObjective(self, func, *args):
        self._link_specs.append(("objective", func, self._pairs(args)))
        return len(self._link_specs) - 1

    def setKKTBackend(self, backend, mesh=None, axis="seg"):
        """'block' (default), 'sharded' or 'dense' (see
        `Phase.setKKTBackend`).  'sharded' lays the concatenated phase
        chain over the mesh: the phases are consecutive spans of one
        global node chain."""
        backend = str(backend)
        if backend not in ("block", "sharded", "dense"):
            raise ValueError(f"unknown KKT backend {backend!r}")
        if backend == "sharded":
            if mesh is None:
                from ..distributed import chain_mesh
                mesh = chain_mesh(axis)
            self.KKTMesh = mesh
            self.KKTAxis = axis
        self.KKTBackend = backend
        return self

    # ------------------------------------------------------------ transcribe
    def transcribe(self, *_):
        key = (tuple(p._structure_key() for p in self.Phases),
               tuple(id(s) for s in self._link_specs), self.KKTBackend,
               id(self.KKTMesh),
               self._link_params.size)
        if self._nlp is not None and key == self._ocp_struct_key:
            # structure unchanged: refresh the consts only (the shifted
            # families share the phase families' consts arrays)
            for p in self.Phases:
                p._refresh_consts(self._nlp)
            return
        offsets, off = [], 0
        for p in self.Phases:
            if p._traj is None:
                raise ValueError("every phase needs an initial trajectory")
            offsets.append(off)
            off += p.numVars
        self._lp_offset = off
        nvars = off + self._link_params.size
        nlp = NonLinearProgram(nvars, device=self.device)
        self._offsets = offsets
        self._offsets_map = {id(p): o for p, o in zip(self.Phases, offsets)}
        # global unit vector: auto-scaled phases expose scaled variables,
        # and link functions must see physical values
        self._Uglob = np.ones(nvars)
        for p, o in zip(self.Phases, offsets):
            if p.AutoScaling:
                self._Uglob[o:o + p.numVars] = p.var_units()
        for p, o in zip(self.Phases, offsets):
            eqs, iqs, objs = p._build_families()
            for fam in eqs:
                nlp.addEqualCon(self._shift(fam, o))
            for fam in iqs:
                nlp.addInequalCon(self._shift(fam, o))
            for fam in objs:
                nlp.addObjective(self._shift(fam, o))
        for spec in self._link_specs:
            self._transcribe_link(nlp, spec)
        nlp.freeze()
        self._nlp = nlp
        kkt = None
        if self.KKTBackend in ("block", "sharded"):
            # phases are consecutive spans of one global node chain
            nov = np.full(nvars, -1, np.int64)
            node_off = 0
            for p, o in zip(self.Phases, offsets):
                pn = p.node_of_var()
                nov[o:o + p.numVars] = np.where(pn >= 0, pn + node_off, -1)
                node_off += p.numNodes
            from ..Solvers.kkt_block import BlockKKT
            try:
                kkt = BlockKKT(nlp, nov, x0=self.makeSolverInput())
                if self.KKTBackend == "sharded":
                    from ..Solvers.kkt_sharded import ShardedBlockKKT
                    kkt = ShardedBlockKKT(kkt, self.KKTMesh, self.KKTAxis)
            except ValueError as e:
                # a structure the block backend cannot hold: PSIOPT builds
                # the dense backend
                if self.optimizer.PrintLevel <= 1:
                    print(f"  [kkt] falling back to dense backend: {e}")
        self.optimizer.setNLP(nlp, kkt)
        self._ocp_struct_key = key
        for p in self.Phases:
            p._active_nlp = nlp

    @staticmethod
    def _shift(fam, offset):
        return IndexedFunction(fam.fun, fam.Vidx + offset, fam.consts,
                               name=fam.name)

    def _region_pack(self, phase, region):
        """Gather spec of one phase region used in links: Front/Back
        ("node": decoded through the node layout) or ODEParams/StaticParams
        ("raw": the gathered parameter vector itself)."""
        offset = self._offsets_map[id(phase)]
        if region in ("Front", "Back"):
            idx, tau = self._boundary_gather(phase, offset, region)
            return ("node", phase, idx, tau)
        if region == "ODEParams":
            return ("raw", phase,
                    [offset + phase._opi(k) for k in range(phase.PV)], 0.0)
        if region == "StaticParams":
            return ("raw", phase,
                    [offset + phase._spi(k) for k in range(phase.SPV)], 0.0)
        raise ValueError(f"unsupported link region {region}")

    def _path_pack(self, phase):
        """Per-node gather of a Path link region: row j gathers [node j
        vars, t0, tf, op, sp]; the node's tau rides in the consts."""
        offset = self._offsets_map[id(phase)]
        m, N = phase._m, phase.numNodes
        tail = [phase._t0i, phase._tfi] \
            + [phase._opi(k) for k in range(phase.PV)] \
            + [phase._spi(k) for k in range(phase.SPV)]
        idx = np.empty((N, m + len(tail)), np.int64)
        idx[:, :m] = offset + np.arange(N)[:, None] * m + np.arange(m)
        idx[:, m:] = offset + np.asarray(tail, np.int64)[None, :]
        return idx, np.asarray(phase.taus)

    def _selector(self, p, region, kind, xtuv, opv, spv):
        """Index tensor of a link region's selected entries: from the
        parameter vector of a raw (ODEParams/StaticParams) region (None:
        all of it), or from the decoded input [x, t, u, op, sp] of a node
        region (None: nothing)."""
        if kind == "raw":
            sel = opv if region == "ODEParams" else spv
        else:
            per = p.XV + 1 + p.UV
            sel = np.concatenate([xtuv, per + opv, per + p.PV + spv])
        return self._ix(sel) if len(sel) else None

    def _pick(self, p, kind, sel_t, g, lo, ln, tau):
        """The selected entries of one region gathered at g[lo:lo + ln]
        (None when a node region selects nothing)."""
        if kind == "raw":
            seg = g[lo:lo + ln]
            return seg if sel_t is None else seg[sel_t]
        if sel_t is None:
            return None
        return torch.cat(self._boundary_input(p, g, lo, tau))[sel_t]

    def _transcribe_path_link(self, nlp, func, sel, lp, kind):
        """Per-node link applications (PathToPath): the phases' Path
        regions are zipped node for node into one family, so every Path
        phase must have the same node count.  Other regions broadcast their
        boundary gather to every node."""
        trace = _tracefun(func)[0]
        packs, idx_parts, tau_cols = [], [], []
        napps, lo = None, 0
        for p, r, xtuv, opv, spv in sel:
            if r in _PATH:
                idx2d, taus = self._path_pack(p)
                if napps is None:
                    napps = idx2d.shape[0]
                elif idx2d.shape[0] != napps:
                    raise ValueError(
                        "PathToPath link requires equal node counts "
                        f"({idx2d.shape[0]} vs {napps})")
                rkind = "node"
            else:
                pack = self._region_pack(p, r)
                idx2d = np.asarray(pack[2], np.int64)[None, :]
                taus = np.asarray([pack[3]])
                rkind = pack[0]
            packs.append((p, lo, idx2d.shape[1], rkind,
                           self._selector(p, r, rkind, xtuv, opv, spv)))
            idx_parts.append(idx2d)
            tau_cols.append(taus)
            lo += idx2d.shape[1]
        if napps is None:
            raise ValueError("path link needs at least one Path region")
        idx_parts = [np.broadcast_to(a, (napps, a.shape[1]))
                     for a in idx_parts]
        tau_cols = [np.broadcast_to(t, (napps,)) for t in tau_cols]
        lpn = len(lp)
        if lpn:
            idx_parts.append(np.broadcast_to(
                self._lp_offset + np.asarray(lp, np.int64)[None, :],
                (napps, lpn)))
        Vidx = np.concatenate(idx_parts, axis=1)
        consts = np.stack(tau_cols, axis=1)              # (napps, nregions)
        nin = Vidx.shape[1]

        def fun(g, c):
            parts = []
            for i, (p, lo_, ln, rkind, sel_t) in enumerate(packs):
                part = self._pick(p, rkind, sel_t, g, lo_, ln, c[i])
                if part is not None:
                    parts.append(part)
            if lpn:
                parts.append(g[nin - lpn:])
            return trace(torch.cat(parts))

        fam = IndexedFunction(fun, Vidx, consts, name="pathlink",
                              in_scales=self._Uglob[Vidx])
        {"objective": nlp.addObjective, "eq": nlp.addEqualCon}[kind](fam)

    def _link_family(self, fun, idx):
        """One-application link family over the global indices `idx`, fed
        physical values."""
        idx = np.asarray([idx], np.int64)
        return IndexedFunction(fun, idx, np.zeros((1, 1)), name="link",
                               in_scales=self._Uglob[idx])

    def _transcribe_link(self, nlp, spec):
        kind = spec[0]
        if kind == "general_idx" and any(s[1] in _PATH for s in spec[2]):
            _, func, sel, lp = spec
            return self._transcribe_path_link(nlp, func, sel, lp, "eq")
        if kind in ("general", "objective") and any(
                r in _PATH for _, r in spec[2]):
            _, func, pr = spec
            sel = [(p, r, np.arange(p.XV + 1 + p.UV), np.arange(p.PV),
                    np.arange(p.SPV)) for p, r in pr]
            return self._transcribe_path_link(
                nlp, func, sel, np.zeros(0, np.int64),
                "objective" if kind == "objective" else "eq")
        if kind == "direct" and (spec[3] in _PATH or spec[6] in _PATH):
            _, func, pa, ra, va, pb, rb, vb = spec
            if func is None:
                A = Arguments(2 * len(va))
                func = A.head(len(va)) - A.segment(len(va), len(va))
            empty = np.zeros(0, np.int64)
            sel = [(pa, ra, va, empty, empty), (pb, rb, vb, empty, empty)]
            return self._transcribe_path_link(nlp, func, sel, empty, "eq")
        if kind == "direct":
            _, func, pa, ra, va, pb, rb, vb = spec
            packa = self._region_pack(pa, ra)
            packb = self._region_pack(pb, rb)
            la = len(packa[2])
            vat, vbt = self._ix(va), self._ix(vb)

            def build_inp(pack, g, lo):
                if pack[0] == "node":
                    return torch.cat(self._boundary_input(pack[1], g, lo,
                                                          pack[3]))
                return g[lo:lo + len(pack[2])]

            if func is None:
                def fun(g, c):
                    return build_inp(packa, g, 0)[vat] \
                        - build_inp(packb, g, la)[vbt]
            else:
                trace = _tracefun(func)[0]

                def fun(g, c):
                    return trace(torch.cat([build_inp(packa, g, 0)[vat],
                                            build_inp(packb, g, la)[vbt]]))
            nlp.addEqualCon(self._link_family(fun, packa[2] + packb[2]))
        elif kind == "general_idx":
            _, func, sel, lp = spec
            trace = _tracefun(func)[0]
            idx, packs = [], []
            for p, r, xtuv, opv, spv in sel:
                pack = self._region_pack(p, r)
                packs.append((pack, len(idx),
                              self._selector(p, r, pack[0], xtuv, opv,
                                             spv)))
                idx += pack[2]
            lp_lo, lpn = len(idx), len(lp)
            idx += [self._lp_offset + int(k) for k in lp]

            def fun(g, c):
                parts = []
                for (rkind, p, gidx, tau), lo, sel_t in packs:
                    part = self._pick(p, rkind, sel_t, g, lo, len(gidx), tau)
                    if part is not None:
                        parts.append(part)
                if lpn:
                    parts.append(g[lp_lo:lp_lo + lpn])
                return trace(torch.cat(parts))
            nlp.addEqualCon(self._link_family(fun, idx))
        elif kind in ("general", "objective"):
            _, func, pr = spec
            trace = _tracefun(func)[0]
            idx, packs, lp_lo = [], [], None
            for p, r in pr:
                if r == "LinkParams":
                    lp_lo = len(idx)
                    idx += [self._lp_offset + k
                            for k in range(self._link_params.size)]
                    continue
                pack = self._region_pack(p, r)
                packs.append((pack, len(idx)))
                idx += pack[2]

            def fun(g, c):
                parts = []
                for pack, lo in packs:
                    if pack[0] == "node":
                        parts += self._boundary_input(pack[1], g, lo,
                                                      pack[3])
                    else:
                        parts.append(g[lo:lo + len(pack[2])])
                if lp_lo is not None:
                    parts.append(g[lp_lo:])
                return trace(torch.cat(parts))

            fam = self._link_family(fun, idx)
            if kind == "objective":
                nlp.addObjective(fam)
            else:
                nlp.addEqualCon(fam)
        elif kind == "linkparams":
            _, func, pidx = spec
            trace = _tracefun(func)[0]
            nlp.addEqualCon(IndexedFunction(
                lambda g, c: trace(g),
                [[self._lp_offset + int(k) for k in pidx]], np.zeros((1, 1)),
                name="linkparam"))

    # --------------------------------------------------------------- solving
    def makeSolverInput(self):
        """The solver's variable vector: every phase's `makeSolverInput()`
        in order, then the link parameters."""
        return np.concatenate(
            [p.makeSolverInput() for p in self.Phases] + [self._link_params])

    def collectSolverOutput(self, V):
        """Set every phase's trajectory and parameters, and the link
        parameters, from the solver vector V (the layout of
        `makeSolverInput`; the problem must have been transcribed)."""
        V = np.asarray(V, np.float64)
        for p, o in zip(self.Phases, self._offsets):
            p.collectSolverOutput(V[o:o + p.numVars])
        if self._link_params.size:
            self._link_params = V[self._lp_offset:].copy()

    def _solve_once(self, method):
        """One solve by the optimizer's `method`.  LastSolveStats holds its
        host seconds outside the optimizer: `transcribe_s` (the structure
        check and the consts' refresh, or a new transcription) and `io_s`
        (the solver vector in and out)."""
        st = self.LastSolveStats = dict(transcribe_s=0.0, io_s=0.0)
        with span(_TRANSCRIBE, st, "transcribe_s"):
            self.transcribe()
        with span(_IO, st, "io_s"):
            V0 = self.makeSolverInput()
        V = getattr(self.optimizer, method)(V0)
        with span(_IO, st, "io_s"):
            self.collectSolverOutput(V)
        return self.optimizer.ConvergeFlag

    def _call(self, method):
        flag = self._solve_once(method)
        if not self.AdaptiveMesh:
            return flag
        # multi-phase adaptive mesh loop: estimate per-phase errors, refine
        # the failing phases, re-transcribe the whole problem, re-solve
        from . import mesh
        for _ in range(max(p.MaxMeshIters for p in self.Phases)):
            all_ok = True
            for i, p in enumerate(self.Phases):
                errs = mesh.segment_errors(p)
                err = mesh._combine(errs, p.MeshErrorCriteria)
                p.MeshConverged = err < p.MeshTol
                if self.optimizer.PrintLevel <= 1:
                    print(f"  [mesh] phase {i}: segs {p.numSegs} "
                          f"err {err:.3e} tol {p.MeshTol:.1e}")
                if not p.MeshConverged:
                    all_ok = False
                    n_new, bounds = mesh.update_mesh(p, errs)
                    p.resampleTraj(n_new, seg_bounds=bounds)
            if all_ok:
                return flag
            flag = self._solve_once(method)
        return flag

    def optimize(self):
        return self._call("optimize")

    def solve(self):
        return self._call("solve")

    def solve_optimize(self):
        return self._call("solve_optimize")

    def solve_optimize_solve(self):
        return self._call("solve_optimize_solve")

    def optimize_solve(self):
        return self._call("optimize_solve")

    def jet_run(self):
        return self._call({"optimize": "optimize", "solve": "solve",
                           "solve_optimize": "solve_optimize"}.get(
                               self.JetJobMode, "optimize"))

    # ------------------------------------------------------------------ misc
    def setThreads(self, *a):
        pass

    def setAdaptiveMesh(self, flag=True, *a):
        self.AdaptiveMesh = bool(flag)
        for p in self.Phases:
            p.setAdaptiveMesh(flag)

    def setAutoScaling(self, flag=True, *a):
        for p in self.Phases:
            p.setAutoScaling(flag)

    def setMeshTol(self, tol):
        for p in self.Phases:
            p.setMeshTol(tol)

    def PrintMeshInfo(self, *a):
        pass

    def setJetJobMode(self, mode):
        self.JetJobMode = mode
