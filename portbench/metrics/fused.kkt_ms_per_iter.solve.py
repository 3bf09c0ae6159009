"""fused.kkt_ms_per_iter.solve: host ms of the block KKT per fused iteration
(`asset.fused.assembly`, `.factor` for every factorization of the ladder,
`.solve` for the probe and Newton solves with the inequality matvecs), the
median over the window's solves."""

from portbench.stages import per_iter


def read(run):
    return per_iter(run, "kkt_s", 1e3)
