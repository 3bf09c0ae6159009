"""kkt_probe_ms.solve: block assembly + BCR factor + BCR solve at the last
solve's final iterate, ms (the same probe as ad_probe_ms.solve)."""


def read(run):
    if not run.probe:
        return None
    p = run.probe
    return 1e3 * (p["assembly"] + p["factor"] + p["solve"])
