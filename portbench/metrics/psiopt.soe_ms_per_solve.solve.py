"""psiopt.soe_ms_per_solve.solve: host ms of a solve's SOE-mode pass
(`PSIOPT.LastFusedStats["soe_s"]`, the `loop_s` of its sigma-0 pass), the
median over the window's solves.  None when no unit holds the counter: a
program whose stats keep the last pass alone."""

import statistics


def read(run):
    vals = [1e3 * s["soe_s"] for s in run.stats if "soe_s" in s]
    return statistics.median(vals) if vals else None
