"""fused.kkt_replay_share.ensemble: the share of the fused loop's
iterations whose block KKT (assembly, factorizations, solves) was replayed
from CUDA graphs, the median over the window's ensemble calls."""

from portbench.kkt_replay import replay_share


def read(run):
    return replay_share(run)
