"""The harness run end to end on the CPU at small sizes: correct runs,
the import check, the control's readings, and the faults that must turn
`correct` false."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, small
from portbench import run, spec

CELLS = [w["name"] for w in spec.bench(ROOT)["workloads"]]
ENSEMBLES = [c for c in CELLS if spec.workload(c)["entry"] == "ensemble"]


def run_small(name, trace=False, seed=2 ** 31 + 7):
    overrides, lanes = small(name)
    return run.run_cell(name, seed, 0.0, trace, device="cpu",
                        overrides=overrides, lanes=lanes)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(name):
    res, found = run_small(name)
    assert res["correct"] and found == []
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end(
        spec.bench(ROOT), name)}
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"


def card_only(m):
    """Whether only a card can give per-layer metric `m`: it is read from
    the device's trace, or its reader gives a number from a run that holds
    nothing but the device's memory peak."""
    if m["source"] == "device_trace":
        return True
    r = run.Run()
    r.window_peak_bytes = 2 ** 30
    try:
        return spec.load_module("metrics", m["name"]).read(r) is not None
    except (TypeError, KeyError, ZeroDivisionError):
        return False


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name, monkeypatch):
    """A traced run with one unit in each of its two traced stretches
    reports every per-layer metric that lists the cell and that the CPU
    can give, and no other."""
    plain = spec.workload
    monkeypatch.setattr(spec, "workload", lambda n: dict(
        plain(n), trace={"from": 1, "units": 1}))
    res, _ = run_small(name, trace=True)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    listed = spec.per_layer(spec.bench(ROOT), name)
    # no device here: the device readers find nothing and stay silent
    assert set(res["metrics"]) == {m["name"] for m in listed
                                   if not card_only(m)}


def test_same_seed_same_starts():
    from portbench.traffic import Starts
    t = spec.workload(ENSEMBLES[0])["traffic"]
    a = Starts(t, np.ones(5), 2 ** 31 + 99).next()
    b = Starts(t, np.ones(5), 2 ** 31 + 99).next()
    c = Starts(t, np.ones(5), 2 ** 31 + 98).next()
    assert (a == b).all() and not (a == c).all()


def test_forbidden_names_are_compared_whole():
    assert run.forbidden_modules({"asset_asrl_torch", "asset_asrl_torch.x",
                                  "jaxtyping", "flaxen"}) == []
    assert run.forbidden_modules({"jax.numpy", "asset_asrl_tpu.Solvers",
                                  "jaxlib", "flax"}) == [
        "asset_asrl_tpu", "flax", "jax", "jaxlib"]


def test_harness_and_references_load_no_jax():
    """run.py with every module a run loads, and each reference alone,
    in fresh processes."""
    code = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "from portbench import run, spec\n"
        "b = spec.bench({root!r})\n"
        "{body}\n"
        "print(sorted({{m.split('.')[0] for m in sys.modules}}))\n")
    body_run = ("import asset_asrl_torch, asset_asrl_torch.parallel\n"
                "for c in b['configs']: spec.load_module('configs', "
                "c['name'])\n"
                "for w in b['workloads']:\n"
                "    spec.load_module('entries', "
                "spec.workload(w['name'])['entry'])\n"
                "for m in b['end_to_end'] + b['per_layer']:\n"
                "    spec.load_module('metrics', m['name'])\n"
                "import portbench.trace, portbench.judge, "
                "portbench.control")
    body_ref = ("for c in b['configs']: spec.load_module('reference', "
                "c['name'])")
    for body, banned in ((body_run, {"jax", "jaxlib", "flax",
                                     "asset_asrl_tpu"}),
                         (body_ref, {"jax", "jaxlib", "flax",
                                     "asset_asrl_tpu", "asset_asrl_torch"})):
        out = subprocess.run([sys.executable, "-c",
                              code.format(root=ROOT, body=body)],
                             capture_output=True, text=True, check=True)
        names = set(eval(out.stdout.strip().splitlines()[-1]))
        assert not names & banned, names & banned


@pytest.mark.parametrize("name", CELLS)
def test_control_readings_fail_the_limits(name):
    """The control (judge.control) at a test's size on three seeds: every
    seed fails a limit, every program reading passes."""
    from portbench import control
    overrides, lanes = small(name)
    cell = run.Cell(name, "cpu", overrides, lanes)
    limits = cell.wl["limits"]
    for seed, w in control.readings(cell, [11, 12, 13], 0.0):
        assert all(w["program"][k] <= limits[k] for k in limits)
        assert any(w["control"][k] > limits[k] for k in limits)


# faults planted under the timed path -------------------------------------

def _unchanged(build):
    """The fused loop returns its state unchanged, claiming convergence."""
    def fake(kkt, opts, mode, *a, **k):
        def go(x, s, lamE, lamI, Mu0, consts):
            B = x.shape[0]
            z = torch.zeros((B,), dtype=torch.int64)
            return (x, s, lamE, lamI, torch.full((B,), float(Mu0),
                                                 dtype=x.dtype),
                    z, z + 1, torch.zeros((B, 1, 9), dtype=x.dtype),
                    x, s, lamE, lamI)
        go.stats = dict(iterations=1, syncs=1, factorizations=0)
        return go
    return fake


def _half_batch(build):
    """Only the first half of the lanes is solved; the rest keep their
    starts and report lane 0's flag, iterations and infos."""
    state = (0, 1, 2, 3, 8, 9, 10, 11)      # x, s, lamE, lamI, best_*

    def fake(kkt, opts, mode, *a, **k):
        real = build(kkt, opts, mode, *a, **k)

        def go(x, s, lamE, lamI, Mu0, consts):
            n, h = x.shape[0], max(x.shape[0] // 2, 1)
            out = list(real(x[:h], s[:h], lamE[:h], lamI[:h], Mu0, consts))
            for i, o in enumerate(out):
                rest = (x, s, lamE, lamI)[i % 4][h:] if i in state \
                    else o[:1].expand(n - h, *o.shape[1:])
                out[i] = torch.cat([o, rest])
            return tuple(out)
        go.stats = real.stats
        return go
    return fake


def _answer_fault(change):
    """`change(out)` applied to lane 0 of the loop's outputs as they leave
    it: out = [x, s, lamE, lamI, Mu, flag, ...]."""
    def make(build):
        def fake(kkt, opts, mode, *a, **k):
            real = build(kkt, opts, mode, *a, **k)

            def go(*args):
                out = [o.clone() for o in real(*args)]
                change(out)
                return tuple(out)
            go.stats = real.stats
            return go
        return fake
    return make


def _alter(out):
    """One variable of lane 0's answer moved by 1e-3."""
    out[0][0, out[0].shape[1] // 2] += 1e-3


def _flip(out):
    """Lane 0's inequality multipliers with the wrong sign."""
    out[3][0] = -out[3][0]


def _inflate(out):
    """Lane 0's inequality multipliers 1e3 times too large: the answer no
    longer complementary where a constraint is slack."""
    out[3][0] = 1e3 * out[3][0]


def _unconverged(out):
    """Lane 0 reports that it did not converge (flag NOTCONVERGED)."""
    out[5][0] = 2


FAULTS = [(c, f) for c in CELLS
          for f in ("unchanged", "altered", "flipped", "inflated",
                    "unconverged")] \
    + [(c, "half_batch") for c in ENSEMBLES]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_turns_correct_false(name, fault, monkeypatch):
    """The harness's run (without its look for a card) with the fused loop
    broken underneath; the baseline of a re-solve cell is solved before
    the fault goes in."""
    from asset_asrl_torch import parallel
    from asset_asrl_torch.Solvers import fused, psiopt
    make = {"unchanged": _unchanged, "half_batch": _half_batch,
            "altered": _answer_fault(_alter), "flipped": _answer_fault(_flip),
            "inflated": _answer_fault(_inflate),
            "unconverged": _answer_fault(_unconverged)}[fault]
    plain = run.Cell.warm

    def warm_then_break(self, seed):
        plain(self, seed)
        monkeypatch.setattr(psiopt, "build_fused_alg",
                            make(fused.build_fused_alg))
        monkeypatch.setattr(parallel, "build_fused_ensemble",
                            make(fused.build_fused_ensemble))
        self.driver.optimizer._fused_cache = None
    monkeypatch.setattr(run.Cell, "warm", warm_then_break)
    res, _ = run_small(name)
    assert res["correct"] is False


def test_cell_on_the_card(card):
    """The first cell through the harness on a CUDA card."""
    res, found = run.run_cell(CELLS[0], 3, 0.5, False, device="cuda")
    assert res["correct"] and not found
    assert res["device"]["platform"] == "gpu"
