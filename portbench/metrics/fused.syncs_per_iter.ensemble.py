"""fused.syncs_per_iter.ensemble: host reads per batched iteration of the
fused loop over the window's ensemble calls."""

from portbench.readers import syncs_per_iter


def read(run):
    return syncs_per_iter(run)
