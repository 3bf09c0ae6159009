"""ocp.outside_loop_ms_per_solve.solve: host ms of a solve outside its
fused loops, the median over the window's solves: the problem's
`transcribe()` refresh and its solver vector in and out
(`OptimalControlProblem.LastSolveStats`), and PSIOPT's own work around
its passes (`run_s` - `loop_s` of `PSIOPT.LastFusedStats`).  None when no
unit holds the counters."""

import statistics

KEYS = ("transcribe_s", "io_s", "run_s", "loop_s")


def read(run):
    vals = [1e3 * (s["transcribe_s"] + s["io_s"] + s["run_s"] - s["loop_s"])
            for s in run.stats if all(k in s for k in KEYS)]
    return statistics.median(vals) if vals else None
