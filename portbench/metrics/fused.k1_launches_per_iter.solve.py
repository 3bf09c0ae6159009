"""fused.k1_launches_per_iter.solve: K1 launches
(`cuda_kernels.gj_inverse.shapes`) per fused iteration, the median over the
window's solves."""

from portbench.stages import per_iter


def read(run):
    return per_iter(run, "k1_launches")
