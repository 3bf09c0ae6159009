"""Carry state from the JAX package (as numpy arrays) into the port.

The JAX package and the port use the same variable layout, row order and
block layout, so an iterate, a set of KKT blocks or a family's gather
table from one can be fed to the other.  These helpers name the dtype and
device of every tensor they make (float64 values, int64 indices).
"""

from __future__ import annotations

import numpy as np

from . import config

__all__ = ["state_from_numpy", "blocks_from_numpy",
           "problem_tables_from_numpy", "iterate_of_problem"]


def _f64(a, device):
    # a copy: arrays from jax are read-only, and the tensor owns its data
    return config.tensor(np.array(a, np.float64), device)


def state_from_numpy(x, s, lamE, lamI, device=None):
    """IPM iterate (x, s, lamE, lamI) as float64 tensors on `device`."""
    return tuple(_f64(a, device) for a in (x, s, lamE, lamI))


def blocks_from_numpy(diag, lower, B, C, device=None):
    """KKT blocks (diag (K,W,W), lower (K,W,W), B (K,W,b), C (b,b)), e.g.
    from the JAX `BlockKKT._blocks_impl`, as float64 tensors on
    `device`."""
    return tuple(_f64(a, device) for a in (diag, lower, B, C))


def problem_tables_from_numpy(Vidx, consts, device=None):
    """A family's gather indices (int64) and per-application constants
    (float64) on `device`."""
    return config.index(np.array(Vidx, np.int64), device), \
        _f64(consts, device)


def iterate_of_problem(problem, device=None):
    """The last iterate of a solved phase or OptimalControlProblem of
    either package, as float64 tensors (x, s, lamE, lamI) on `device`.

    x is the problem's solver input (`makeSolverInput()` of a phase,
    `_make_input()` of a multi-phase problem: every phase's variables,
    static parameters included, then the link parameters); s, lamE and
    lamI are the optimizer's `LastSlacks`, `LastEqLmults` and
    `LastIqLmults`.  The two packages share the variable layout and the
    row order, so the result can be factored by the port's KKT backend
    for a side-by-side comparison of one factor/solve."""
    make = getattr(problem, "_make_input", None) or problem.makeSolverInput
    opt = problem.optimizer
    return state_from_numpy(np.asarray(make()), np.asarray(opt.LastSlacks),
                            np.asarray(opt.LastEqLmults),
                            np.asarray(opt.LastIqLmults), device)
