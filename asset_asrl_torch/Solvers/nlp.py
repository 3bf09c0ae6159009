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

__all__ = ["IndexedFunction", "NonLinearProgram"]


class IndexedFunction:
    """A function kind + the index sets of all its applications.

    fun: callable (xloc (nin,), consts (nc,)) -> (nout,) on tensors.
    Vidx: (napps, nin) int array of global variable indices per application.
    consts: (napps, nc) float array of per-application constants.
    """

    def __init__(self, fun, Vidx, consts=None, name="fun"):
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
        self._consts = tuple(
            tuple(config.tensor(f.consts, dev) for f in fams)
            for fams in (self.objectives, self.eqcons, self.iqcons))
        self._val = [(_family_value(f.fun), config.index(f.Vidx, dev))
                     for f in self.objectives + self.eqcons + self.iqcons]

    # ------------------------------------------------------- value pass
    def eval_obj_cons(self, x):
        """Objective value + raw constraint residuals (used by the merit
        line search).  Rows are contiguous per family in family order, so
        cE/cI are plain concatenations."""
        ocon, econ, icon = self.consts_dev()
        nobj, neq = len(self.objectives), len(self.eqcons)
        vals = [fval(x[vidx], cc).reshape(-1)
                for (fval, vidx), cc in zip(self._val, ocon + econ + icon)]
        obj = torch.zeros((), dtype=config.DTYPE, device=self.device)
        for v in vals[:nobj]:
            obj = obj + torch.sum(v)

        def cat(parts, m):
            return torch.cat(parts) if parts else \
                torch.zeros((m,), dtype=config.DTYPE, device=self.device)
        cE = cat(vals[nobj:nobj + neq], self.numEq)
        cI = cat(vals[nobj + neq:], self.numIq)
        return obj, cE, cI

    def __repr__(self):
        return (f"<NonLinearProgram n={self.numPrimal} "
                f"eqfams={len(self.eqcons)} iqfams={len(self.iqcons)} "
                f"objfams={len(self.objectives)}>")
