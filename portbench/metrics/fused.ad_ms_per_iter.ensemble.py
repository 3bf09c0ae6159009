"""fused.ad_ms_per_iter.ensemble: host ms of family AD
(`asset.fused.family_ad`) per batched iteration of the fused loop, the
median over the window's ensemble calls."""

from portbench.stages import per_iter


def read(run):
    return per_iter(run, "ad_s", 1e3)
