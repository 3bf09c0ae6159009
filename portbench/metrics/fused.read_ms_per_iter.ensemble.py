"""fused.read_ms_per_iter.ensemble: host ms blocked in the fused loop's host
reads (`asset.fused.read`) per batched iteration, the median over the
window's ensemble calls."""

from portbench.stages import per_iter


def read(run):
    return per_iter(run, "read_s", 1e3)
