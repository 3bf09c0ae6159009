"""Jet: run many optimization problems.

Port of `asset_asrl_tpu/Solvers/jet.py`.  `Jet.map(gen, args, nthreads)`
builds a problem per argument tuple (or takes a list of built problems)
and runs each one's `jet_run()` in turn.  The solves cannot overlap in
threads: `torch.func`'s forward-mode AD levels (the family Jacobians and
Hessians) are process-wide, and two solves differentiating at once corrupt
each other's levels.  So `nthreads` is accepted for the JAX package's
signature and ignored.  For B problems of one structure,
`asset_asrl_torch.parallel.solve_ensemble` runs them as one batched solve
on the device.
"""

from __future__ import annotations

import sys

__all__ = ["Jet", "map"]


class Jet:

    @staticmethod
    def map(gen, args, nthreads=4, verbose=False, jobmode=None):
        """Build a problem per argument tuple and run its jet job, one
        problem after the other (`nthreads` is ignored).

        gen: callable(*arg) -> problem (phase, ocp, OptimizationProblem),
        or a list of built problems.  Returns the problems (each one's
        flag lives on its optimizer); a convergence tally is printed when
        verbose."""
        if callable(gen):
            problems = [gen(*(a if isinstance(a, (list, tuple)) else (a,)))
                        for a in args]
        else:
            problems = list(gen)
        flags = []
        for i, p in enumerate(problems):
            if jobmode is not None and hasattr(p, "setJetJobMode"):
                p.setJetJobMode(jobmode)
            flags.append(p.jet_run())
            if verbose:
                sys.stdout.write(f"\rJet: {i + 1}/{len(problems)} done")
                sys.stdout.flush()
        if verbose:
            tally = {}
            for f in flags:
                tally[f] = tally.get(f, 0) + 1
            print(f"\nJet: {len(problems)} problems, flags {tally}")
        return problems


def map(gen, args, nthreads=4, verbose=False):  # noqa: A001
    return Jet.map(gen, args, nthreads, verbose)
