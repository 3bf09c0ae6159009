#!/usr/bin/env python3
"""The readings that set a cell's limits: the program's answers and the
control's, over several seeds, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13
        --seconds <s>

For each seed it runs the cell's window (the benchmark's own set-up and
window, at the cell's size) and prints, for each number `judge.py`
compares, the worst over the window's answers: first the program's, then
the control's (`judge.control`: every answer rounded to float32, the
objective the reference's in float32).  The benchmark's own runs never
run the control.  Without a CUDA card it exits with code 3; the tests
call `readings(...)` on the CPU at a small size.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import judge  # noqa: E402
from portbench.run import Cell, set_caches  # noqa: E402


def readings(cell, seeds, seconds):
    """[(seed, answers, {program: worst, control: worst})] for each seed:
    the worst of each number over the window's answers."""
    out = []
    for seed in seeds:
        run, units = cell.window(seed, seconds, False)
        ans = cell.answers(units)
        prog = cell.judge(ans)
        ctrl = judge.readings(cell.ref, cell.cfg,
                              judge.control(cell.ref, cell.cfg, ans,
                                            cell.device), cell.device)
        worst = {who: {k: float(v.max()) for k, v in r.items()}
                 for who, r in (("program", prog), ("control", ctrl))}
        worst["answers"] = int(len(ans["obj"]))
        worst["failed"] = int((ans["flag"] != 0).sum())
        worst["unit_secs"] = run.unit_secs
        out.append((seed, worst))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    set_caches()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    cell = Cell(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    cell.warm(seeds[0])
    print(f"set-up {time.perf_counter() - t0:.3f} s", flush=True)
    for seed, w in readings(cell, seeds, a.seconds):
        print(json.dumps(dict(workload=a.workload, seed=seed, **w)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
