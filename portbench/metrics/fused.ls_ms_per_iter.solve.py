"""fused.ls_ms_per_iter.solve: host ms of the merit line search
(`asset.fused.line_search`: its MaxLSIters value passes) per fused
iteration, the median over the window's solves."""

from portbench.stages import per_iter


def read(run):
    return per_iter(run, "ls_s", 1e3)
