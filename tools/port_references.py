"""The JAX package's reference numbers that `chip_smoke.py` holds the
PyTorch port to on the card (phases 15 and 16), computed on the CPU with
x64 and the package's own jitted solves.

    JAX_PLATFORMS=cpu python tools/port_references.py [--all]

Prints one JSON line each: the default (fused) solve's flag, iterations
and objective of the Brachistochrone (LGL3, 24 segments) and the CartPole
(LGL5, 40 segments) -> `FUSED`; `PSIOPT.init` on the 40-segment CartPole
with a control guess of 1 -> `INIT_40`; ReturnBest on the Brachistochrone
capped at 4 iterations -> `RETURN_BEST`; the MultiSpacecraft leg's
baseline solve -> `MSC_BASE`.  With --all also the CartPole at 5000
segments (about 70 s) and formation flying at 256 segments a phase (two
linked phases, about 80 s) -> `FUSED`, and the 512-scenario
`solve_ensemble` about the MultiSpacecraft baseline (about 30 s) ->
`MSC_512`.
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import asset_asrl_tpu as ast  # noqa: E402
from asset_asrl_tpu.parallel import solve_ensemble  # noqa: E402
from chip_smoke import (build_brachistochrone, build_cartpole,  # noqa: E402
                        build_formation, build_multispacecraft)


def solved(phase, **knobs):
    opt = phase.optimizer
    opt.set_PrintLevel(2)
    for k, v in knobs.items():
        setattr(opt, k, v)
    flag = phase.optimize()
    return [int(flag), opt.LastIterNum, repr(opt.LastObjVal)]


def main():
    full = "--all" in sys.argv[1:]

    def show(name, value):
        print(json.dumps({name: value}), flush=True)

    show("FUSED Brachistochrone LGL3 24",
         solved(build_brachistochrone(ast, "LGL3", 24)))
    show("FUSED CartPole LGL5 40", solved(build_cartpole(ast, 40)))
    ph = build_cartpole(ast, 40, u0=1.0)
    ph.transcribe()
    lamE = ph.optimizer.init(ph.makeSolverInput())[2]
    show("INIT_40", [repr(float(np.linalg.norm(lamE))),
                     [repr(float(v)) for v in lamE[:4]],
                     int(np.abs(lamE).argmax())])
    show("RETURN_BEST", solved(build_brachistochrone(ast, "LGL3", 24),
                               MaxIters=4, ReturnBest=True))
    msc = build_multispacecraft(ast)
    show("MSC_BASE", solved(msc))
    if not full:
        return
    show("FUSED CartPole LGL5 5000", solved(build_cartpole(ast, 5000)))
    show("FUSED formation 256", solved(build_formation(ast, 256)[0]))
    base = np.asarray(msc.makeSolverInput())
    rng = np.random.default_rng(7)
    perts = [rng.normal(size=base.shape) * 1e-4 for _ in range(512)]
    res = solve_ensemble(msc, perturb_states=perts)
    show("MSC_512", [np.unique(res["flags"]).tolist(),
                     np.unique(res["iters"]).tolist(),
                     [repr(float(v)) for v in res["objs"][:4]]])


if __name__ == "__main__":
    main()
