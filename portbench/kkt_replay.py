"""Arithmetic of the per-layer metrics that read the block KKT's graph
counters: the fused iterations whose block KKT was replayed from CUDA
graphs (`kkt_replays`) and run eagerly (`kkt_eager`), which the fused loop
keeps in `fn.stats` and the entries copy into `run.stats` once a unit."""

import statistics


def replay_share(run):
    """The median over the window's units of the unit's replayed
    iterations over all its iterations.  None when no unit holds the
    counters: a program without the block KKT's graphs."""
    vals = [s["kkt_replays"] / (s["kkt_replays"] + s["kkt_eager"])
            for s in run.stats
            if s.get("kkt_replays", 0) + s.get("kkt_eager", 0) > 0]
    return statistics.median(vals) if vals else None
