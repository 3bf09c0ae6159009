"""scenarios_per_s: scenarios whose lane converged, over the window's
time."""


def read(run):
    return sum(run.converged) / run.window_s
