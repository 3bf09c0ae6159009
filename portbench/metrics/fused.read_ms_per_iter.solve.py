"""fused.read_ms_per_iter.solve: host ms blocked in the fused loop's host
reads (`asset.fused.read`: the outer check and the ladder's), the time the
device set the pace, per iteration, the median over the window's solves."""

from portbench.stages import per_iter


def read(run):
    return per_iter(run, "read_s", 1e3)
