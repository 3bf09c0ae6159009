"""How far an example's result moves when its solver's starting point
moves by rounding: each run multiplies the x0 of every PSIOPT solve by
1 + 1e-10 N(0, 1) (a seeded draw a run), in the JAX package or in the
port, on the CPU.

    JAX_PLATFORMS=cpu python tools/perturbed_examples.py jax|port LABEL \
        [--size=test|full] [--seeds=N]

Prints one JSON line a run: seed, every solve's flag and iterations, and
the objectives of the solves that optimize.  Seed 0 is the unperturbed
run.  `LABEL` is a key of `chip_smoke.EXAMPLES`."""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    pkg, label = sys.argv[1], sys.argv[2]
    opts = dict(a[2:].split("=") for a in sys.argv[3:] if a.startswith("--"))
    if pkg == "jax":
        from port_references import JaxExamples, ast
        ex = JaxExamples()
    else:
        import torch
        torch.set_num_threads(2)
        import asset_asrl_torch as ast
        ast.config.use_device("cpu")
        from chip_smoke import PortExamples
        ex = PortExamples()
    from chip_smoke import EXAMPLES, run_example
    spec = EXAMPLES[label]
    call = spec.full if opts.get("size") == "full" else spec.test
    psiopt = ast.Solvers.PSIOPT
    plain = psiopt._run
    for seed in range(int(opts.get("seeds", 8))):
        rng = np.random.default_rng(seed)

        def perturbed(self, x0, schedule):
            x0 = np.asarray(x0, np.float64)
            if seed:
                x0 = x0 * (1 + 1e-10 * rng.normal(size=x0.shape))
            return plain(self, x0, schedule)
        psiopt._run = perturbed
        try:
            cited, solves, secs = run_example(ast, ex, call)
        finally:
            psiopt._run = plain
        print(json.dumps({"seed": seed, "flags": [s[0] for s in solves],
                          "iters": [s[1] for s in solves],
                          "objs": [s[2] for s in solves if s[3]],
                          "cited": cited, "seconds": round(secs, 1)}),
              flush=True)


if __name__ == "__main__":
    main()
