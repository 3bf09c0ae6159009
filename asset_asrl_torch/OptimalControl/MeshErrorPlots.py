"""Mesh-error plotting helper: a phase's segment error estimates over
normalized phase time, beside its MeshTol."""

import numpy as np


def PhaseMeshErrorPlot(phase, show=True):
    from .mesh import segment_errors
    errs = segment_errors(phase)
    mids = 0.5 * (phase.seg_bounds[:-1] + phase.seg_bounds[1:])
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        print("mesh errors:", errs)
        return errs
    plt.semilogy(mids, np.maximum(errs, 1e-18), marker="o")
    plt.axhline(phase.MeshTol, color="k", linestyle="--",
                label=f"MeshTol {phase.MeshTol:g}")
    plt.xlabel("normalized phase time")
    plt.ylabel("segment error estimate")
    plt.grid(True)
    plt.legend()
    if show:
        plt.show()
    return errs
