"""NonLinearProgram: batched assembly of objective/constraint families.

Port of `asset_asrl_tpu/Solvers/nlp.py` (the f64 batch-major family AD and
the value pass the line search uses).

A *family* is one function applied at many index sets: e.g. the LGL5
defect applied to every segment of a phase, or a variable bound applied at
every node.  Per-application constant data (mesh fractions, bound values)
rides along in `consts`, so one closure serves every application, and each
family is evaluated with one `torch.func.vmap` over all its applications.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vjp, vmap

from .. import config
from ..Utils import span

_VALUE_PASS = "asset.nlp.value_pass"       # profiler range (`Utils.span`)

__all__ = ["IndexedFunction", "NonLinearProgram"]


class IndexedFunction:
    """A function kind + the index sets of all its applications.

    fun: callable (xloc (nin,), consts (nc,)) -> (nout,) on tensors.
    Vidx: (napps, nin) int array of global variable indices per application.
    consts: (napps, nc) float array of per-application constants.
    in_scales (napps, nin), out_scales (napps, nout): auto-scaling.  The
    variable units and row scales are folded into the function through
    per-application constants, appended after the original consts, so every
    consumer (dense and block assembly, residuals, sparsity probing) sees
    the scaled problem: fun_scaled(g, c) = out * fun(in * g, c[:nc]).
    """

    def __init__(self, fun, Vidx, consts=None, name="fun", in_scales=None,
                 out_scales=None):
        self.fun = fun
        self.Vidx = np.asarray(Vidx, dtype=np.int64)
        if self.Vidx.ndim != 2:
            raise ValueError("Vidx must be (napps, nin)")
        self.napps, self.nin = self.Vidx.shape
        if consts is None:
            consts = np.zeros((self.napps, 0))
        self.consts = np.asarray(consts, dtype=np.float64)
        if self.consts.ndim == 1:
            self.consts = self.consts[:, None]
        if self.consts.shape[0] != self.napps:
            raise ValueError(f"{name}: consts rows != napps")
        self.name = name
        if in_scales is not None or out_scales is not None:
            nc0, nin = self.consts.shape[1], self.nin
            ins = np.ones((self.napps, nin)) if in_scales is None \
                else np.asarray(in_scales, np.float64)
            cols = [self.consts, ins]
            nout = 0
            if out_scales is not None:
                cols.append(np.asarray(out_scales, np.float64))
                nout = cols[-1].shape[1]
            self.consts = np.concatenate(cols, axis=1)
            base = fun

            def scaled(g, c):
                out = torch.atleast_1d(base(c[nc0:nc0 + nin] * g, c[:nc0]))
                if nout:
                    out = c[nc0 + nin:nc0 + nin + nout] * out
                return out
            self.fun = fun = scaled
        # output width: one call on zeros
        out = fun(torch.zeros(self.nin, dtype=config.DTYPE,
                              device=config.DEVICE),
                  torch.zeros(self.consts.shape[1], dtype=config.DTYPE,
                              device=config.DEVICE))
        self.nout = int(torch.atleast_1d(out).numel())

    def __repr__(self):
        return (f"<IndexedFunction {self.name}: {self.napps} apps, "
                f"{self.nin}->{self.nout}>")


def _family_value(fun):
    def one(xloc, consts):
        return torch.atleast_1d(fun(xloc, consts))
    return vmap(one)


def _family_valjac(fun):
    """Value and Jacobian of every application, one vmapped forward-mode
    pass: (napps, nout), (napps, nout, nin)."""
    def one(xloc, consts):
        def f(z):
            out = torch.atleast_1d(fun(z, consts))
            return out, out
        jx, fx = jacfwd(f, has_aux=True)(xloc)
        return fx, jx
    return vmap(one)


def _family_hess(fun):
    """Adjoint Hessian grad^2 (lam^T f) of every application
    (forward-over-reverse): (napps, nin, nin)."""
    def one(xloc, consts, lam):
        def f(z):
            return torch.atleast_1d(fun(z, consts))

        def agrad(z):
            return vjp(f, z)[1](lam)[0]
        return jacfwd(agrad)(xloc)
    return vmap(one)


def _family_full(fun):
    """Value, Jacobian and adjoint Hessian of every application in one
    vmapped pass: (napps, nout), (napps, nout, nin), (napps, nin, nin)."""
    def one(xloc, consts, lam):
        def f(z):
            out = torch.atleast_1d(fun(z, consts))
            return out, out
        jx, fx = jacfwd(f, has_aux=True)(xloc)

        def agrad(z):
            return vjp(lambda y: f(y)[0], z)[1](lam)[0]
        return fx, jx, jacfwd(agrad)(xloc)
    return vmap(one)


class NonLinearProgram:
    """Assembles families into one NLP.

    Variable vector x has `numPrimal` entries.  Constraint rows are assigned
    contiguously per family, equality rows and inequality rows in separate
    spaces.  Inequality convention: c_I(x) <= 0 with slack c_I + s = 0,
    s >= 0.
    """

    def __init__(self, numPrimal, device=None):
        self.numPrimal = int(numPrimal)
        self.device = config.DEVICE if device is None else device
        self.objectives: list[IndexedFunction] = []
        self.eqcons: list[IndexedFunction] = []
        self.iqcons: list[IndexedFunction] = []
        self._frozen = False

    # ------------------------------------------------------------- consts
    def consts_dev(self):
        """(obj, eq, iq) tuples of the families' consts as device tensors.
        They are arguments of every evaluator (not baked into the
        closures), so they can change without rebuilding the program."""
        return self._consts

    def bump_consts(self):
        """Re-read the families' (host) consts after they were changed in
        place (lock data, mesh fractions)."""
        dev = self.device
        self._consts = tuple(
            tuple(config.tensor(np.array(f.consts), dev) for f in fams)
            for fams in (self.objectives, self.eqcons, self.iqcons))

    # ----------------------------------------------------------- families
    def addObjective(self, f: IndexedFunction):
        if f.nout != 1:
            raise ValueError("objective families must have scalar output")
        self.objectives.append(f)

    def addEqualCon(self, f: IndexedFunction):
        self.eqcons.append(f)

    def addInequalCon(self, f: IndexedFunction):
        self.iqcons.append(f)

    # ------------------------------------------------------------- freezing
    def freeze(self):
        """Assign constraint rows and build the family evaluators."""
        if self._frozen:
            return
        self._frozen = True

        def rows_of(fams):
            row, out = 0, []
            for f in fams:
                out.append(row + np.arange(f.napps * f.nout,
                                           dtype=np.int64).reshape(
                                               f.napps, f.nout))
                row += f.napps * f.nout
            return out, row

        self._eq_rows, self.numEq = rows_of(self.eqcons)
        self._iq_rows, self.numIq = rows_of(self.iqcons)
        dev = self.device
        self.bump_consts()
        self._val = [(_family_value(f.fun), config.index(f.Vidx, dev))
                     for f in self.objectives + self.eqcons + self.iqcons]
        self._dense = None          # eval_kkt's plan, built at first use

    # ------------------------------------------------------- value pass
    def eval_obj_cons_impl(self, x, consts):
        """Objective value + raw constraint residuals of every lane (the
        line search's value pass): x (B, n) -> obj (B,), cE (B, mE), cI
        (B, mI).  Each family runs once over the (B*napps) rows of every
        lane's applications, the consts shared by every lane.  Rows are
        contiguous per family in family order, so cE/cI are plain
        concatenations."""
        ocon, econ, icon = consts
        Bn, dev = x.shape[0], self.device
        nobj, neq = len(self.objectives), len(self.eqcons)

        def cat(parts, m):
            return torch.cat(parts, 1) if parts else \
                torch.zeros((Bn, m), dtype=config.DTYPE, device=dev)
        with span(_VALUE_PASS):
            vals = [fval(x[:, vidx].reshape(-1, vidx.shape[1]),
                         cc.repeat(Bn, 1)).reshape(Bn, -1)
                    for (fval, vidx), cc in zip(self._val,
                                                ocon + econ + icon)]
            obj = torch.zeros((Bn,), dtype=config.DTYPE, device=dev)
            for v in vals[:nobj]:
                obj = obj + v.sum(-1)
            cE = cat(vals[nobj:nobj + neq], self.numEq)
            cI = cat(vals[nobj + neq:], self.numIq)
        return obj, cE, cI

    def eval_obj_cons(self, x):
        """`eval_obj_cons_impl` of one problem (x (n,))."""
        obj, cE, cI = self.eval_obj_cons_impl(x[None], self.consts_dev())
        return obj[0], cE[0], cI[0]

    # ------------------------------------------------------- dense KKT pass
    def _dense_plan(self):
        """Gather tables that sum every family's Jacobian / adjoint-Hessian
        values into the dense [gradf | H | JE | JI] arrays (targets repeat
        wherever applications share variables, so no index_add)."""
        from .kkt_block import _gather_rows
        n, dev = self.numPrimal, self.device
        mE, mI = self.numEq, self.numIq
        offH, offE = n, n + n * n
        offI = offE + mE * n
        pairs, off = [], 0
        fams = [(f, None, offH) for f in self.objectives] \
            + [(f, r, offE) for f, r in zip(self.eqcons, self._eq_rows)] \
            + [(f, r, offI) for f, r in zip(self.iqcons, self._iq_rows)]
        for f, rows, joff in fams:
            V = f.Vidx
            nj = f.napps * f.nout * f.nin
            if rows is None:      # objective: gradient entries
                jt = np.broadcast_to(V[:, None, :], (f.napps, 1, f.nin))
            else:
                jt = joff + rows[:, :, None] * n + V[:, None, :]
            pairs.append((off + np.arange(nj), jt.ravel()))
            off += nj
            nh = f.napps * f.nin * f.nin
            pairs.append((off + np.arange(nh),
                          (offH + V[:, :, None] * n + V[:, None, :]).ravel()))
            off += nh
        targets, table = _gather_rows(pairs, off)
        full = [_family_full(f.fun) for f, _, _ in fams]
        vidx = [config.index(f.Vidx, dev) for f, _, _ in fams]
        rows = [None if r is None else config.index(r, dev)
                for _, r, _ in fams]
        self._dense = dict(targets=config.index(targets, dev),
                           table=config.index(table, dev), size=offI + mI * n,
                           full=full, vidx=vidx, rows=rows)
        return self._dense

    def eval_kkt(self, x, lamE, lamI, sigma):
        """Dense KKT data: obj, gradf (scaled by sigma), cE, cI,
        H = sigma grad^2 f + sum lam grad^2 c, JE, JI (the dense backend's
        input)."""
        p = self._dense or self._dense_plan()
        n, mE, mI, dev = self.numPrimal, self.numEq, self.numIq, self.device
        ocon, econ, icon = self.consts_dev()
        nobj, neq = len(self.objectives), len(self.eqcons)
        obj = torch.zeros((), dtype=config.DTYPE, device=dev)
        vals, ce, ci = [], [], []
        for i, cc in enumerate(ocon + econ + icon):
            fam = (self.objectives + self.eqcons + self.iqcons)[i]
            if i < nobj:
                lam = torch.ones((fam.napps, 1), dtype=config.DTYPE,
                                 device=dev)
            else:
                lam = (lamE if i < nobj + neq else lamI)[p["rows"][i]]
            fx, jx, hx = p["full"][i](x[p["vidx"][i]], cc, lam)
            if i < nobj:
                obj = obj + torch.sum(fx)
                jx, hx = sigma * jx, sigma * hx
            else:
                (ce if i < nobj + neq else ci).append(fx.reshape(-1))
            vals += [jx.reshape(-1), hx.reshape(-1)]
        buf = torch.cat(vals + [torch.zeros(1, dtype=config.DTYPE,
                                            device=dev)])
        out = torch.zeros(p["size"], dtype=config.DTYPE, device=dev)
        out[p["targets"]] = buf[p["table"]].sum(-1)
        gradf = out[:n]
        H = out[n:n + n * n].reshape(n, n)
        JE = out[n + n * n:n + n * n + mE * n].reshape(mE, n)
        JI = out[n + n * n + mE * n:].reshape(mI, n)
        empty = torch.zeros((0,), dtype=config.DTYPE, device=dev)
        cE = torch.cat(ce) if ce else empty
        cI = torch.cat(ci) if ci else empty
        return obj, gradf, cE, cI, H, JE, JI

    def __repr__(self):
        return (f"<NonLinearProgram n={self.numPrimal} "
                f"eqfams={len(self.eqcons)} iqfams={len(self.iqcons)} "
                f"objfams={len(self.objectives)}>")
