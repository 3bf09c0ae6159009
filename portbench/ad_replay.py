"""Arithmetic of the per-layer metrics that read the family AD's graph
counters: the passes of `BlockKKT._eval_core` replayed from a CUDA graph
(`ad_replays`) and run eagerly (`ad_eager`), which the fused loop keeps in
`fn.stats` and the entries copy into `run.stats` once a unit."""

import statistics


def replay_share(run):
    """The median over the window's units of the unit's replayed passes
    over all its passes.  None when no unit holds the counters: a program
    without the graph cache."""
    vals = [s["ad_replays"] / (s["ad_replays"] + s["ad_eager"])
            for s in run.stats
            if s.get("ad_replays", 0) + s.get("ad_eager", 0) > 0]
    return statistics.median(vals) if vals else None
