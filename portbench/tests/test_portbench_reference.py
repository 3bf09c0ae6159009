"""Each plain reference against the port's CPU solve at a small mesh: the
same constraints in the same order, the solution accepted, a perturbed
one rejected; and the roofline's K1 bound against PERF.md.  The problem
is reached only through its first cell's Driver (`spec.py`)."""

import numpy as np
import pytest
import torch

from conftest import ROOT, small
from portbench import judge, roofline, run, spec

B = spec.bench(ROOT)
CONFIGS = [c["name"] for c in B["configs"]]


def first_cell(config):
    return next(w["name"] for w in B["workloads"] if w["config"] == config)


def limits(config):
    """The limits of the configuration's first cell."""
    return spec.workload(first_cell(config))["limits"]


@pytest.fixture(scope="module")
def solved():
    """solved(config) -> (cfg, reference, driver, answers): the
    configuration's first cell's Driver at a CPU test's size, after one
    unit from its base, and lane 0 of that unit's answers (solved once a
    configuration, on first use)."""
    import asset_asrl_torch as ast
    ast.config.use_device("cpu")
    done = {}

    def get(name):
        if name not in done:
            first = first_cell(name)
            cell = run.Cell(first, "cpu", *small(first))
            d = cell.driver
            out = d.unit(d.base[None])
            assert out["flag"][0] == 0
            ans = {k: np.asarray(out[k][:1])
                   for k in ("x", "lamE", "lamI", "obj", "flag")}
            ans["sigma"] = d.sigma
            done[name] = (cell.cfg, cell.ref, d, ans)
        return done[name]
    return get


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_states_the_transcription(solved, name):
    cfg, ref, driver, ans = solved(name)
    x = ans["x"][0]
    obj, eq, iq = ref.problem(cfg, torch.tensor(x[None]))
    pobj, peq, piq = driver.nlp.eval_obj_cons(torch.tensor(x))
    assert eq.shape[1] == peq.shape[0] and iq.shape[1] == piq.shape[0]
    assert (eq[0] - peq).abs().max() < 1e-12
    assert (iq[0] - piq).abs().max() < 1e-12
    assert abs(float(obj[0] - pobj)) < 1e-12 * abs(float(pobj))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_accepts_the_solution(solved, name):
    cfg, ref, _, ans = solved(name)
    _, ok = judge.checks(judge.readings(ref, cfg, ans, "cpu"), limits(name))
    assert ok


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("scale", [1e-4, 1e-6])
def test_reference_rejects_a_perturbed_solution(solved, name, scale):
    cfg, ref, _, ans = solved(name)
    x = ans["x"][0]
    x = x * (1.0 + scale * np.random.default_rng(3).standard_normal(x.size))
    lim = limits(name)
    c, ok = judge.checks(judge.readings(ref, cfg, dict(ans, x=x[None]),
                                        "cpu"), lim)
    assert not ok and c["feas"]["value"] > lim["feas"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("fault,number", [(-1.0, "dual"), (1e3, "compl")])
def test_reference_rejects_wrong_multipliers(solved, name, fault, number):
    """The solution with its inequality multipliers negated (wrong sign)
    or 1e3 times too large (not complementary) is rejected by that
    number."""
    cfg, ref, _, ans = solved(name)
    ans = dict(ans, lamI=fault * ans["lamI"])
    lim = limits(name)
    c, ok = judge.checks(judge.readings(ref, cfg, ans, "cpu"), lim)
    assert not ok and c[number]["value"] > lim[number]


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails(solved, name):
    """The solution rounded to float32, its objective the reference's in
    float32, comes out not correct."""
    cfg, ref, _, ans = solved(name)
    ans = judge.control(ref, cfg, ans, "cpu")
    lim = limits(name)
    c, ok = judge.checks(judge.readings(ref, cfg, ans, "cpu"), lim)
    assert not ok and c["obj_gap"]["value"] > 10 * lim["obj_gap"]


# PERF.md section 6: (K, W) -> K1's bound in ms, as printed (6 decimals)
K1_TABLE = {(2500, 24): 0.007024, (5002, 25): 0.015236,
            (2501, 25): 0.007618, (156, 24): 0.000438, (1, 24): 0.000003,
            (514, 8): 0.000168, (25, 11): 0.000015,
            (40000, 24): 0.112382, (3072, 22): 0.007266,
            (512, 3): 0.000026, (2496, 24): 0.007013,
            (1248, 24): 0.003506, (624, 24): 0.001753, (4, 24): 0.000011,
            (500, 45): 0.004890, (96, 46): 0.000981,
            (1, 255): 0.000495, (1, 261): 0.000531, (1, 517): 0.004125,
            (1, 1029): 0.032524}


@pytest.mark.parametrize("shape", sorted(K1_TABLE))
def test_k1_bound_reproduces_the_table(shape):
    secs, by = roofline.k1_bound(*shape)
    assert round(1e3 * secs, 6) == K1_TABLE[shape]
    assert by == ("operations" if shape[1] > 64 else "bytes")
