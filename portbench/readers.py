"""Arithmetic that several metric readers share.  Each reader takes the
`run.Run` of one run and returns a number, or None when the run holds
nothing for it to read; a share of a roofline is never reported as 0."""


def solves(run):
    return sum(run.lanes)


def syncs_per_iter(run):
    """Host reads of the fused loop per outer iteration, summed over the
    window's units (`PSIOPT.LastFusedStats`)."""
    syncs = sum(s.get("syncs", 0) for s in run.stats)
    iters = sum(s.get("iterations", 0) for s in run.stats)
    return syncs / iters if iters else None


def k1_roofline_pct(run):
    """The K1 bound of every `_inv_sym` call of the traced stretch over
    the device time of every operation launched inside those calls."""
    t = run.traced
    if not t or not t["k1_s"] or not t["k1_bound_s"]:
        return None
    return 100.0 * t["k1_bound_s"] / t["k1_s"]


def device_idle_pct(run):
    """1 - the union of device operations over the traced stretch."""
    t = run.traced
    if not t or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
