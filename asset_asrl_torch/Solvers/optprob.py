"""Generic (non-ODE) optimization problem.

Port of `asset_asrl_tpu/Solvers/optprob.py`: the user attaches
VectorFunctions as objectives / equality / inequality constraints applied
at explicit variable-index lists; `optimize()` returns the convergence
flag and `returnVars()` the solution.  Such a problem has no node chain,
so PSIOPT solves it on the dense KKT backend (the host loop).
"""

from __future__ import annotations

import numpy as np
import torch

from ..VectorFunctions.function import VectorFunction
from .nlp import IndexedFunction, NonLinearProgram
from .psiopt import PSIOPT

__all__ = ["OptimizationProblem"]


def _index_matrix(func, indices):
    """Normalize the user's index argument into an (napps, IRows) array."""
    idx = np.asarray(indices, dtype=np.int64)
    if idx.ndim == 1:
        idx = idx[None, :]
    if idx.shape[1] != func.IRows():
        raise ValueError(
            f"index list width {idx.shape[1]} != function input size "
            f"{func.IRows()}")
    return idx


def _family(func: VectorFunction, idx, name):
    return IndexedFunction(lambda x, c: torch.atleast_1d(func.trace(x)),
                           idx, name=name)


class OptimizationProblem:

    def __init__(self):
        self.optimizer = PSIOPT()
        self._vars = None
        self._objs = []
        self._eqs = []
        self._iqs = []
        self.Threads = 1
        self.JetJobMode = "optimize"

    # ----------------------------------------------------------------- vars
    def setVars(self, x):
        self._vars = np.asarray(x, dtype=np.float64).ravel()

    def returnVars(self):
        return np.asarray(self._vars)

    def numVars(self):
        return 0 if self._vars is None else self._vars.size

    # ------------------------------------------------------------- functions
    def addObjective(self, func: VectorFunction, indices):
        if func.ORows() != 1:
            raise ValueError("objective must be scalar-valued")
        self._objs.append((func, _index_matrix(func, indices)))

    def addEqualCon(self, func: VectorFunction, indices):
        self._eqs.append((func, _index_matrix(func, indices)))

    def addInequalCon(self, func: VectorFunction, indices):
        self._iqs.append((func, _index_matrix(func, indices)))

    # ---------------------------------------------------------------- solve
    def _transcribe(self):
        nlp = NonLinearProgram(self.numVars())
        for f, idx in self._objs:
            nlp.addObjective(_family(f, idx, "obj"))
        for f, idx in self._eqs:
            nlp.addEqualCon(_family(f, idx, "eq"))
        for f, idx in self._iqs:
            nlp.addInequalCon(_family(f, idx, "iq"))
        nlp.freeze()
        self.optimizer.setNLP(nlp)

    def _call(self, method):
        if self._vars is None:
            raise ValueError("setVars() must be called before solving")
        self._transcribe()
        self._vars = getattr(self.optimizer, method)(self._vars)
        return self.optimizer.ConvergeFlag

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
        """The job `Jet.map` runs: the solve named by JetJobMode."""
        return self._call({"optimize": "optimize", "solve": "solve",
                           "solve_optimize": "solve_optimize"}.get(
                               self.JetJobMode, "optimize"))

    def setThreads(self, *args):
        pass  # the solve's parallelism is the device's

    def setJetJobMode(self, mode):
        self.JetJobMode = mode
