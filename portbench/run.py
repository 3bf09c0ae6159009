#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Set-up (the torch import, CUDA start, the
port's import with K1 built on a fresh checkout and loaded, the problem
transcribed, one warm unit) ends where the window begins; its split by
those steps goes to standard error and to the result's "setup_split".  The window repeats the
cell's unit (a solve, or an ensemble call) on starts drawn from --seed
until the first unit that ends after --seconds.  Then every answer is
judged against the configuration's plain reference (`judge.py`).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1, read by `metrics/<name>.py`), device,
with --trace 1 breakdown, and last the numbers compared with their
limits, which also end standard error.  Exit codes: 3 without the CUDA
cards the cell asks for, 4 when the JAX package or JAX was loaded, 1 on
any other failure; no result is printed then.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# top-level module names the process must not hold once the window ends
FORBIDDEN = ("jax", "jaxlib", "flax", "asset_asrl_tpu")


def set_caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (K1's nvcc output goes to the port's own `asset_asrl_torch/_build/`)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["MPLBACKEND"] = "Agg"


# (step, perf_counter at its end) of set-up, in order
MARKS = []


def mark(step):
    MARKS.append((step, time.perf_counter()))


def setup_split(t_start=T_START):
    """{step: seconds} of the set-up steps marked so far."""
    out, t = {}, t_start
    for step, at in MARKS:
        out[step] = at - t
        t = at
    return out


def forbidden_modules(modules=None):
    """The FORBIDDEN top-level names among `modules` (default:
    sys.modules), compared whole: `asset_asrl_torch` is not
    `asset_asrl_tpu`, nor `jaxtyping` `jax`."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Run:
    """What the metric readers read (`metrics/<name>.py`: read(run))."""

    def __init__(self):
        self.setup_s = self.window_s = None
        self.unit_secs, self.lanes, self.converged = [], [], []
        self.stats = []
        self.window_peak_bytes = None
        self.probe = None
        self.traced = None


def _sync(device):
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


class Cell:
    """One cell, set up: its files loaded by name and its driver built
    (the problem transcribed).
    overrides: keys of the configuration to change (the tests' small
    meshes); lanes: another lane count for an ensemble cell."""

    def __init__(self, name, device="cuda", overrides=None, lanes=None,
                 root=ROOT):
        sys.path.insert(0, root)
        from portbench import spec
        b = spec.bench(root)
        self.name, self.device = name, device
        self.cell = spec.cell(b, name)
        self.wl = spec.workload(name)
        self.traffic = dict(self.wl["traffic"],
                            **({"lanes": lanes} if lanes else {}))
        config = spec.load_module("configs", self.cell["config"])
        self.cfg = dict(config.CONFIG, **(overrides or {}))
        self.metrics = {t: spec.per_layer(b, name) if t
                        else spec.end_to_end(b, name) for t in (0, 1)}
        self.readers = {m["name"]: spec.load_module("metrics", m["name"])
                        for ms in self.metrics.values() for m in ms}
        self.ref = spec.load_module("reference", self.cell["config"])
        entry = spec.load_module("entries", self.wl["entry"])
        import asset_asrl_torch as ast
        ast.config.use_device(device)
        if device == "cuda":
            from asset_asrl_torch.Solvers import cuda_kernels
            cuda_kernels.build()
        mark("import_port_and_k1")
        self.driver = entry.Driver(ast, config, self.cfg, self.traffic)
        self.sigma = self.driver.sigma
        mark("build_and_transcribe")

    def warm(self, seed):
        """One unit from the warm-up stream of `seed`: every shape the
        window uses is built once."""
        from portbench.traffic import Starts
        self.driver.unit(Starts(self.traffic, self.driver.base, seed,
                                1).next())
        _sync(self.device)

    def window(self, seed, seconds, trace, t_start=None):
        """Repeat the unit on starts drawn from `seed` until the first
        unit that ends after `seconds`.  With `trace`, the spans are
        installed and, by the workload's "trace" entry, units [from, from
        + units) run under the profiler with device activity only and the
        next `units` with the host's operations too.  Returns (Run, the
        answers of every unit)."""
        import torch
        from portbench.trace import Spans, device, host, profiled
        from portbench.traffic import Starts
        cuda = self.device == "cuda"
        driver = self.driver
        spans = Spans().install() if trace else None
        # traced units: [lo, mid) with device activity only, [mid, hi)
        # with the host's operations and the spans too
        lo = int(self.wl["trace"]["from"])
        mid = lo + int(self.wl["trace"]["units"])
        hi = mid + int(self.wl["trace"]["units"])
        starts = Starts(self.traffic, driver.base, seed, 0)
        run = Run()
        answers, tr = [], {}
        stretch = contextlib.ExitStack()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if t_start is not None:
            run.setup_s = t0 - t_start
        try:
            while True:
                i = len(run.unit_secs)
                x0 = starts.next()
                if trace and i in (lo, mid):
                    stretch.close()
                    tr[i] = stretch.enter_context(
                        profiled(self.device, host=i == mid))
                    spans.logging = i == mid
                tu = time.perf_counter()
                with torch.profiler.record_function(driver.unit_name):
                    out = driver.unit(x0)
                _sync(self.device)
                run.unit_secs.append(time.perf_counter() - tu)
                if trace and i == hi - 1:
                    spans.logging = False
                    stretch.close()
                answers.append(out)
                run.lanes.append(len(out["flag"]))
                run.converged.append(int((out["flag"] == 0).sum()))
                run.stats.append(out["stats"])
                if time.perf_counter() - t0 >= seconds \
                        and (not trace or i >= hi - 1):
                    break
            run.window_s = time.perf_counter() - t0
        finally:
            stretch.close()
            if spans is not None:
                spans.remove()
        if cuda:
            run.window_peak_bytes = torch.cuda.max_memory_allocated()
        if trace:
            run.traced = dict(device(tr[lo]["events"], tr[lo]["window_s"]),
                              **host(tr[mid]["events"], spans.k1))
        return run, answers

    def read(self, run, trace):
        """The metrics of this cell and mode that the run holds."""
        values = {}
        for m in self.metrics[int(trace)]:
            v = self.readers[m["name"]].read(run)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        return values

    def answers(self, units):
        """The answers of every unit, concatenated."""
        import numpy as np
        cat = {k: np.concatenate([a[k] for a in units])
               for k in ("x", "lamE", "lamI", "obj", "flag")}
        cat["sigma"] = self.sigma
        return cat

    def judge(self, answers):
        """judge.readings of the answers by the plain reference."""
        from portbench import judge
        return judge.readings(self.ref, self.cfg, answers, self.device)

    def free(self):
        """Drop the program's state, so that the reference's memory does
        not add to it."""
        import torch
        self.driver = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


def run_cell(name, seed, seconds, trace, device="cuda", overrides=None,
             lanes=None, root=ROOT, t_start=T_START):
    """Run cell `name` once on `device` ("cuda", or "cpu" for the
    tests); returns (result dict, forbidden modules found after the
    window)."""
    import torch
    from portbench import judge
    cuda = device == "cuda"
    cell = Cell(name, device, overrides, lanes, root)
    cell.warm(seed)
    mark("warm_unit")
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    run, units = cell.window(seed, seconds, trace, t_start)
    found = forbidden_modules()
    if trace and hasattr(cell.driver, "probe"):
        run.probe = cell.driver.probe()
    values = cell.read(run, trace)
    cell.free()
    checks, ok = judge.checks(cell.judge(cell.answers(units)),
                              cell.wl["limits"])

    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=int(cell.cell["chips"]),
               memory_peak_bytes=int(max(peak_setup,
                                         run.window_peak_bytes or 0)))
    result = dict(correct=bool(ok and not found),
                  attempted=int(sum(run.lanes)),
                  failed=int(sum(run.lanes) - sum(run.converged)),
                  metrics=values, device=dev)
    if trace:
        t = run.traced
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = dict(device_ops=t["device_ops"],
                                   idle_gaps=t["idle_gaps"])
    result["setup_split"] = setup_split(t_start)
    result["checks"] = checks
    return result, found


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_caches()
    sys.path.insert(0, ROOT)
    from portbench import spec
    chips = int(spec.cell(spec.bench(ROOT), a.workload)["chips"])
    import torch
    mark("import_torch")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.empty(1, device="cuda")
    mark("cuda_start")
    result, found = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the "
              f"window", file=sys.stderr)
        return 4
    print("setup_split " + " ".join(
        f"{k} {v!r}" for k, v in result["setup_split"].items()),
        file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
