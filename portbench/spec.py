"""Finding a cell's files by name, and which metrics a cell reports.

Every piece is a file of its own under `portbench/`, so that a later
change adds a cell, a configuration, an entry or a metric by adding files
and `BENCHMARK.json` entries, and edits none:

    workloads/<cell>.json    traffic, entry and correctness limits
    configs/<config>.py      CONFIG, SOURCE, REDUCED, ASSUMED, build()
    entries/<entry>.py       Driver: the unit of work the window repeats
    metrics/<metric>.py      read(run) -> a number, or None
    reference/<config>.py    problem(cfg, X): the plain reference
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
