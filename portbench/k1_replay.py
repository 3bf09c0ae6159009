"""Arithmetic of the per-layer metrics `k1_roofline.<cell>`: K1's share
of its roofline over every K1 launch of a cell's host-traced units, those
replayed from CUDA graphs included.

`trace.host` takes K1's bound from the `_inv_sym` calls it sees on the
host (`k1_bound_s`) and K1's time from every kernel named `gj_*_kernel`.
A launch replayed from a CUDA graph makes no host call, so its time is
counted there and its bound is not.  The fused loop counts those launches
in `fn.stats` (`k1_replayed`, and `k1_replayed.<K>x<W>` at each shape),
which the entries copy into `run.stats` once a unit; the bound here adds
them for the host-traced units, which the cell's workload file places
("trace": the `units` units after the first `units` traced ones, as
`run.Cell.window` runs them)."""

from portbench import spec
from portbench.roofline import k1_bound


def k1_roofline(run, cell):
    """100 x (the bound of the `_inv_sym` calls seen on the host + the
    bound of the launches replayed in the host-traced units) / K1's device
    time there.  None without a traced K1 time, or when a host-traced unit
    holds no `k1_replayed`: a program that counts no replayed launch."""
    t = run.traced
    trace = spec.workload(cell)["trace"]
    n = int(trace["units"])
    units = run.stats[int(trace["from"]) + n:int(trace["from"]) + 2 * n]
    if not t or not t["k1_s"] or not units \
            or any("k1_replayed" not in s for s in units):
        return None
    bound = t["k1_bound_s"] or 0.0
    for s in units:
        for key, launches in s.items():
            if key.startswith("k1_replayed."):
                K, W = map(int, key.split(".", 1)[1].split("x"))
                bound += launches * k1_bound(K, W)[0]
    return 100.0 * bound / t["k1_s"] if bound else None
