"""Finding a cell's files by name, and which metrics a cell reports.

Every piece is a file of its own under `portbench/`, so that a later
change adds a cell, a configuration, an entry or a metric by adding files
and `BENCHMARK.json` entries, and edits none:

    workloads/<cell>.json    config, entry, why, traffic, trace, limits
    configs/<config>.py      CONFIG, SOURCE, REDUCED, ASSUMED,
                             TEST_OVERRIDES, build(ast, cfg)
    entries/<entry>.py       TEST_LANES, Driver: the unit the window repeats
    metrics/<metric>.py      read(run) -> a number, or None
    reference/<config>.py    problem(cfg, X): the plain reference

A configuration's `CONFIG` is the problem as it is run, and
`TEST_OVERRIDES` the keys of it that a CPU test changes (a mesh the CPU
solves in seconds).  An entry's `TEST_LANES` is the lanes of one unit in
a CPU test, or None for the traffic's own.  `build(ast, cfg)` poses the
problem with the port's public API, given as `ast`, so that the file
imports no part of the program.

`Driver(ast, config, cfg, traffic)` is all that the harness and its tests
know of a problem.  It exposes:

    unit_name    the name of the profiler range around one unit
    unit(starts) solve from starts (lanes, n); returns the answers x,
                 lamE, lamI (lanes, ...), obj, flag, iters (lanes,) and
                 stats (the fused loop's counters of the unit)
    base         the start (n,) that the traffic perturbs
    sigma        the objective's scale in the Lagrangian
    optimizer    the PSIOPT instance that `unit` runs
    nlp          the transcribed problem's NonLinearProgram

and optionally `probe()`, stage seconds read after the window.  A Driver
may hold a Phase, an OptimalControlProblem or anything else: nothing
outside its entry reaches the problem but through these names.

A configuration joins by new files and entries alone: its config file
and reference, a workload file for each cell (and an entry file where no
entry fits), and in `BENCHMARK.json` the configuration, each cell, and
each cell appended to the `workloads` of the end-to-end metric it reports
and of the per-layer metrics it gives.
"""

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench(root=ROOT):
    """BENCHMARK.json of the checkout at `root`."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _path(kind, name, ext):
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return os.path.join(HERE, kind, name + ext)


def load_module(kind, name):
    """The module `portbench/<kind>/<name>.py`, loaded from its file (the
    names hold '-' and '.', so they are not importable by name)."""
    path = _path(kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name):
    with open(_path("workloads", name, ".json")) as f:
        return json.load(f)


def cell(b, name):
    """The `workloads` entry of BENCHMARK.json named `name`."""
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def end_to_end(b, name):
    """The end-to-end metrics cell `name` reports."""
    return [m for m in b["end_to_end"]
            if "workloads" not in m or name in m["workloads"]]


def per_layer(b, name):
    """The per-layer metrics cell `name` reports: those that list it
    (every per-layer entry lists its cells)."""
    for m in b["per_layer"]:
        if "workloads" not in m:
            raise ValueError(f"per-layer metric {m['name']!r} lists no "
                             f"workloads")
    return [m for m in b["per_layer"] if name in m["workloads"]]
