"""fused.ad_replay_share.solve: the share of the fused loop's family-AD
passes (`BlockKKT._eval_core`) replayed from a CUDA graph, the median over
the window's solves."""

from portbench.ad_replay import replay_share


def read(run):
    return replay_share(run)
