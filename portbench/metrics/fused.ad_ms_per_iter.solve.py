"""fused.ad_ms_per_iter.solve: host ms of family AD (`asset.fused.family_ad`:
the loop's and the multiplier start's `BlockKKT._eval_core`) per fused
iteration, the median over the window's solves."""

from portbench.stages import per_iter


def read(run):
    return per_iter(run, "ad_s", 1e3)
