"""fused.kkt_replay_share.solve: the share of the fused loop's iterations
whose block KKT (assembly, factorizations, solves) was replayed from CUDA
graphs, the median over the window's solves."""

from portbench.kkt_replay import replay_share


def read(run):
    return replay_share(run)
