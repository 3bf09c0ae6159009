"""Shuttle reentry max-crossrange with adaptive mesh (reference
`examples/MeshRefinement/Reentry.py`): known objectives 0.59588 rad
(unconstrained) per Betts."""

from ..Reentry import run_reentry


def run(nsegs=40, estimator="deboor", print_level=1):
    return run_reentry(nsegs=nsegs, adaptive=True, estimator=estimator,
                       print_level=print_level)


if __name__ == "__main__":
    out = run()
    print("MeshRefinement Reentry:", out)
