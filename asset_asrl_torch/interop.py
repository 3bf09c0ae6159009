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
           "problem_tables_from_numpy", "iterate_of_problem",
           "phase_state_to_numpy", "load_phase_state"]


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


def solver_input(problem):
    """The solver vector of a phase or an OptimalControlProblem of either
    package: its `makeSolverInput()` (the JAX package's multi-phase
    problem names it `_make_input()`)."""
    make = getattr(problem, "makeSolverInput", None) or problem._make_input
    return np.asarray(make())


def iterate_of_problem(problem, device=None):
    """The last iterate of a solved phase or OptimalControlProblem of
    either package, as float64 tensors (x, s, lamE, lamI) on `device`.

    x is the problem's solver input (`solver_input`: every phase's
    variables, static parameters included, then the link parameters of a
    multi-phase problem); s, lamE and lamI are the optimizer's
    `LastSlacks`, `LastEqLmults` and `LastIqLmults`.  The two packages
    share the variable layout and the row order, so the result can be
    factored by the port's KKT backend for a side-by-side comparison of
    one factor/solve."""
    opt = problem.optimizer
    return state_from_numpy(solver_input(problem),
                            np.asarray(opt.LastSlacks),
                            np.asarray(opt.LastEqLmults),
                            np.asarray(opt.LastIqLmults), device)


def phase_state_to_numpy(phase):
    """What a solved phase of either package holds, as numpy arrays: the
    trajectory rows [x, t, u], the normalized segment bounds, the ODE and
    static parameters and the equality multipliers (None before a
    solve)."""
    lam = phase.optimizer.LastEqLmults
    return dict(traj=np.array(phase._traj, np.float64),
                seg_bounds=np.array(phase.seg_bounds, np.float64),
                odeparams=np.array(phase._odeparams, np.float64),
                static_params=np.array(phase._static_params, np.float64),
                eq_mults=None if lam is None else np.array(lam, np.float64))


def load_phase_state(phase, state):
    """Put a state from `phase_state_to_numpy` into a phase built over the
    same ODE and transcription: mesh, trajectory, parameters and equality
    multipliers.  The phase re-transcribes at its next solve."""
    bounds = np.array(state["seg_bounds"], np.float64)
    traj = np.array(state["traj"], np.float64)
    phase._numsegs = len(bounds) - 1
    phase._node_structure(phase._numsegs, seg_bounds=bounds)
    if traj.shape != (phase.numNodes, phase.XV + 1 + phase.UV):
        raise ValueError(f"trajectory of shape {traj.shape} does not fit "
                         f"{phase.numNodes} nodes")
    phase._traj = traj
    phase.t0, phase.tf = float(traj[0, phase.XV]), float(traj[-1, phase.XV])
    phase._odeparams = np.array(state["odeparams"], np.float64)
    phase._static_params = np.array(state["static_params"], np.float64)
    phase.SPV = phase._static_params.size
    if state["eq_mults"] is not None:
        phase.optimizer.LastEqLmults = np.array(state["eq_mults"],
                                                np.float64)
    phase._need_transcribe = True
    return phase
