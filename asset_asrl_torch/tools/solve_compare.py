"""Time the CartPole solve of this checkout beside an earlier one's, on one
card, in turns.

    python3 -m asset_asrl_torch.tools.solve_compare --old-tree DIR \
        [--nsegs 5000] [--out FILE.json]

DIR is an unpacked earlier revision of the repository (`git archive REV |
tar -x -C DIR`).  Each tree runs in a process of its own, in the order
old, new, new, old; each process builds K1, then times with a host clock
ending in a synchronize:

    integrator_s   4096 two-body rows through DOPRI87 (`chip_smoke.py`
                   phase 11's batch): code both trees share, so it reads
                   the speed of the host that dispatches the kernels
    host           the CartPole of `chip_smoke.build_cartpole` at
                   `--nsegs` LGL5 segments through `optimize()` on the host
                   loop (`UseFused = False`)
    default        the same problem with the tree's default settings (the
                   fused loop where the tree has it)

each as [seconds, flag, iterations, objective], one JSON line a process.
The card's name and power limit end the output.
"""

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
import asset_asrl_torch as ast
from asset_asrl_torch.Solvers import cuda_kernels as ck
ck.build()
nsegs = int(sys.argv[1])
out = {}
rows, periods = cs.two_body_rows(4096)
integ = cs.two_body_ode(ast).integrator("DOPRI87", 0.1)
integ.integrate_parallel(rows[:64], periods[:64])
torch.cuda.synchronize()
t0 = time.perf_counter()
integ.integrate_parallel(rows, periods)
torch.cuda.synchronize()
out["integrator_s"] = time.perf_counter() - t0
for name in ("host", "default"):
    ph = cs.build_cartpole(ast, nsegs)
    ph.optimizer.set_PrintLevel(2)
    if name == "host":
        ph.optimizer.UseFused = False
    ph.transcribe()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flag = ph.optimize()
    torch.cuda.synchronize()
    out[name] = [time.perf_counter() - t0, int(flag),
                 ph.optimizer.LastIterNum, ph.optimizer.LastObjVal]
print("RESULT " + json.dumps(out))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-tree", required=True)
    ap.add_argument("--nsegs", type=int, default=5000)
    ap.add_argument("--out")
    args = ap.parse_args()
    results = []
    for label, tree in (("old", args.old_tree), ("new", "."),
                        ("new", "."), ("old", args.old_tree)):
        r = subprocess.run([sys.executable, "-c", CHILD, str(args.nsegs)],
                           cwd=tree, capture_output=True, text=True,
                           timeout=900)
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if r.returncode != 0 or not line:
            sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
            raise SystemExit(f"the {label} tree's run failed")
        res = dict(tree=label, **json.loads(line[0][len("RESULT "):]))
        results.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
