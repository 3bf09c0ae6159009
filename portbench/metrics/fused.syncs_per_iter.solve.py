"""fused.syncs_per_iter.solve: host reads per iteration of the fused loop
over the window's solves."""

from portbench.readers import syncs_per_iter


def read(run):
    return syncs_per_iter(run)
