"""Arithmetic of the per-layer metrics that read the fused loop's stage
counters: the host seconds by stage and the K1 launches that
`fused.build_fused_alg` keeps in `fn.stats`, which the entries copy into
`run.stats` once a unit (`PSIOPT.LastFusedStats`)."""

import statistics


def per_iter(run, key, scale=1.0):
    """The median over the window's units of the unit's `key` over its
    outer iterations, times `scale` (the median keeps out the traced
    units, which the profiler slows).  None when no unit holds the key: a
    program without the counter."""
    vals = [scale * s[key] / s["iterations"] for s in run.stats
            if key in s and s.get("iterations")]
    return statistics.median(vals) if vals else None
