"""solve_s: the window's time over the solves it held (a closed loop of
one caller; a stall anywhere in the window shows)."""

from portbench.readers import solves


def read(run):
    n = solves(run)
    return run.window_s / n if n else None
