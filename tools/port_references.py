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

    JAX_PLATFORMS=cpu python tools/port_references.py --astro

prints only the references of phases 17 and 18 instead (about 10 min):
the table-driven climb at 50 segments -> `CLIMB_50`; the Kepler
root-finder family on its first 4 rows (values, Jacobians, adjoint
Hessians) -> `KEPLER_FAMILY_4`; Lambert on the 64 seeded lanes of the
porkchop grid -> `PORKCHOP_64`; the Dionysus transfer at 150 segments
(flag, iterations, final mass in kg) -> `DIONYSUS_150`.

    JAX_PLATFORMS=cpu python tools/port_references.py --dionysus-16

prints the Dionysus transfer at 16 segments that
`tests/test_torch_astro_solve.py` holds the port to (about 1 min): flag,
iterations, final mass in kg, objective, and the trajectory rows of
nodes 0, 8, 16, 24 and 32 -> `DIONYSUS_16`.

    JAX_PLATFORMS=cpu python tools/port_references.py --examples \
        [LABEL ...] [--size=test|--size=full]

runs the JAX package's example scripts (`examples/`, loaded from their
files by `JaxExamples`) through the entries of `chip_smoke.EXAMPLES`
(all of them, or the labels given), at the JAX test's call and at phase
21's full call, and prints for each every solve's flag and iterations,
the objectives of the solves that optimize (null where one failed), the
numbers its test cites and the seconds it took -> `EXAMPLES_JAX` in
`chip_smoke.py` (`tests/test_torch_examples_jax.py` holds those constants
to the JAX scripts, `slow`).  All of them take
about 100 minutes on an 8-core CPU (46 in three processes side by side); the
two Betts transfers about 16 minutes each, Heteroclinic 8, everything
else under 5.

    JAX_PLATFORMS=cpu python tools/port_references.py --porkchop-arrivals

runs the whole 512 x 512 porkchop grid through Lambert and 16 chained
(and, apart, one) `propagate_kepler` steps in the JAX package and in the
port on the CPU (about 1 min), and prints for each the lanes that do not
land on their arrival state (1e-8), how many of those pass within 0.1 AU
of the Sun, the lanes both packages miss, and the largest
`conic_residuals` of the Lambert solutions (a witness that uses neither
propagator nor Lambert solver) -> `PORKCHOP_ARRIVALS`.
"""

import importlib.util
import json
import os
import runpy
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import asset_asrl_tpu as ast  # noqa: E402
from asset_asrl_tpu.parallel import solve_ensemble  # noqa: E402
from chip_smoke import (DIONYSUS_MASS, EXAMPLES,  # noqa: E402
                        build_brachistochrone, build_cartpole, build_climb,
                        build_dionysus, run_example,
                        build_formation, build_multispacecraft,
                        conic_residuals, kepler_family, kepler_rows,
                        porkchop, porkchop_lanes)


def solved(phase, **knobs):
    opt = phase.optimizer
    opt.set_PrintLevel(2)
    for k, v in knobs.items():
        setattr(opt, k, v)
    flag = phase.optimize()
    return [int(flag), opt.LastIterNum, repr(opt.LastObjVal)]


def floats(a):
    return [float(v) for v in np.asarray(a).ravel()]


def astro(show):
    show("CLIMB_50", solved(build_climb(ast, 50)))
    f = kepler_family(ast)
    x, lam = kepler_rows(4)

    def all3(y, l):
        ag = lambda z: jax.vjp(f.trace, z)[1](l)[0]  # noqa: E731
        return f.trace(y), jax.jacfwd(f.trace)(y), jax.jacfwd(ag)(y)
    out = jax.jit(jax.vmap(all3))(jnp.asarray(x), jnp.asarray(lam))
    show("KEPLER_FAMILY_4", [floats(a) for a in out])
    r1, r2, tof = porkchop()
    k = porkchop_lanes()
    v1, v2 = ast.Astro.lambert_izzo_batch(r1[k], r2[k], tof[k])
    show("PORKCHOP_64", [floats(v1), floats(v2)])
    ph = build_dionysus(ast, 150)
    flag, it, _ = solved(ph)
    show("DIONYSUS_150", [flag, it, float(np.asarray(ph.returnTraj())[-1][6]
                                          * DIONYSUS_MASS)])


def dionysus_16(show):
    ph = build_dionysus(ast, 16)
    flag, it, obj = solved(ph)
    traj = np.asarray(ph.returnTraj())
    show("DIONYSUS_16", [flag, it, float(traj[-1][6] * DIONYSUS_MASS),
                         float(obj), [floats(traj[i]) for i in
                                      (0, 8, 16, 24, 32)]])


def porkchop_arrivals(show):
    import asset_asrl_torch as tast
    tast.config.use_device("cpu")
    r1, r2, tof = porkchop()
    out, missed = {}, {}
    for name, pkg in (("jax", ast), ("port", tast)):
        v1, v2 = (np.asarray(v) for v in
                  pkg.Astro.lambert_izzo_batch(r1, r2, tof))
        h = np.cross(r1, v1)
        a = -0.5 / (0.5 * (v1 * v1).sum(1) - 1 / np.linalg.norm(r1, axis=1))
        grazing = a * (1 - np.sqrt(np.maximum(0.0, 1 - (h * h).sum(1) / a))) \
            < 0.1
        row = {"conic_residual": float(conic_residuals(r1, v1, r2, v2,
                                                       tof).max())}
        for steps in (16, 1):
            x = np.concatenate([r1, v1], axis=1)
            for _ in range(steps):
                x = np.asarray(pkg.Astro.propagate_kepler(x, tof / steps))
            miss = ~((np.abs(x[:, :3] - r2).max(1) <= 1e-8)
                     & (np.abs(x[:, 3:] - v2).max(1) <= 1e-8))
            missed[name, steps] = miss
            row[f"miss_{steps}"] = int(miss.sum())
            row[f"miss_{steps}_grazing"] = int((miss & grazing).sum())
        out[name] = row
    for steps in (16, 1):
        out[f"both_miss_{steps}"] = int((missed["jax", steps]
                                         & missed["port", steps]).sum())
    show("PORKCHOP_ARRIVALS", out)


class JaxExamples:
    """The JAX package's scripts under `examples/`, loaded from their
    files: `module(name)` runs one's definitions, `main(name)` runs it as
    a script and returns its globals.  `examples/` goes on sys.path, as
    the JAX package's tests put it there: the MeshRefinement and
    UpdatedInterface scripts import their base examples from it."""
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "examples")

    def __init__(self):
        if self.root not in sys.path:
            sys.path.insert(0, self.root)

    def path(self, name):
        return os.path.join(self.root, *name.split(".")) + ".py"

    def module(self, name):
        spec = importlib.util.spec_from_file_location(
            "jax_example_" + name.replace(".", "_"), self.path(name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def main(self, name):
        return runpy.run_path(self.path(name), run_name="__main__")


def example_refs(show, labels, sizes):
    """The JAX package's run of each example of `labels` at each call of
    `sizes` ("test": the JAX test's, "full": phase 21's)."""
    ex = JaxExamples()
    for label in labels:
        spec = EXAMPLES[label]
        for size in sizes:
            call = spec.test if size == "test" else spec.full
            if call is None or (size == "full" and spec.full is spec.test
                                and "test" in sizes):
                continue
            cited, solves, secs = run_example(ast, ex, call)
            show(f"{label} {size}", {
                "flags": [s[0] for s in solves],
                "iters": [s[1] for s in solves],
                "objs": [s[2] if s[0] < 2 else None
                         for s in solves if s[3]],
                "cited": cited, "seconds": round(secs, 1),
                "same_as_test": spec.full is spec.test})


def main():
    full = "--all" in sys.argv[1:]

    def show(name, value):
        print(json.dumps({name: value}), flush=True)

    if "--astro" in sys.argv[1:]:
        return astro(show)
    if "--dionysus-16" in sys.argv[1:]:
        return dionysus_16(show)
    if "--porkchop-arrivals" in sys.argv[1:]:
        return porkchop_arrivals(show)
    if "--examples" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--examples") + 1:]
        sizes = [a[7:] for a in rest if a.startswith("--size=")] \
            or ["test", "full"]
        labels = [a for a in rest if not a.startswith("--")] \
            or list(EXAMPLES)
        return example_refs(show, labels, sizes)

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
