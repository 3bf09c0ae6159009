"""Each plain reference against the port's CPU solve at a small mesh: the
same constraints in the same order, the solution accepted, a perturbed
one rejected; and the roofline's K1 bound against PERF.md."""

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL
from portbench import judge, roofline, spec

CONFIGS = sorted(SMALL)
B = spec.bench(ROOT)


def limits(config):
    """The limits of the configuration's first cell."""
    cell = next(w for w in B["workloads"] if w["config"] == config)
    return spec.workload(cell["name"])["limits"]


@pytest.fixture(scope="module")
def solved():
    """{config: (cfg, reference, phase)} solved by the port on the CPU."""
    import asset_asrl_torch as ast
    ast.config.use_device("cpu")
    out = {}
    for name in CONFIGS:
        config = spec.load_module("configs", name)
        cfg = dict(config.CONFIG, **SMALL[name][0])
        phase = config.build(ast, cfg)
        phase.optimizer.set_PrintLevel(3)
        assert phase.optimize() == 0
        out[name] = (cfg, spec.load_module("reference", name), phase)
    return out


def answers(phase, x=None):
    opt = phase.optimizer
    x = phase.makeSolverInput() if x is None else x
    return dict(x=x[None], lamE=opt.LastEqLmults[None],
                lamI=opt.LastIqLmults[None],
                obj=np.array([opt.LastObjVal]), flag=np.zeros(1),
                sigma=opt.ObjScale)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_states_the_transcription(solved, name):
    cfg, ref, phase = solved[name]
    x = phase.makeSolverInput()
    obj, eq, iq = ref.problem(cfg, torch.tensor(x[None]))
    pobj, peq, piq = phase._nlp.eval_obj_cons(torch.tensor(x))
    assert eq.shape[1] == peq.shape[0] and iq.shape[1] == piq.shape[0]
    assert (eq[0] - peq).abs().max() < 1e-12
    assert (iq[0] - piq).abs().max() < 1e-12
    assert abs(float(obj[0] - pobj)) < 1e-12 * abs(float(pobj))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_accepts_the_solution(solved, name):
    cfg, ref, phase = solved[name]
    _, ok = judge.checks(judge.readings(ref, cfg, answers(phase), "cpu"),
                         limits(name))
    assert ok


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("scale", [1e-4, 1e-6])
def test_reference_rejects_a_perturbed_solution(solved, name, scale):
    cfg, ref, phase = solved[name]
    x = phase.makeSolverInput()
    x = x * (1.0 + scale * np.random.default_rng(3).standard_normal(x.size))
    lim = limits(name)
    c, ok = judge.checks(judge.readings(ref, cfg, answers(phase, x), "cpu"),
                         lim)
    assert not ok and c["feas"]["value"] > lim["feas"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("fault,number", [(-1.0, "dual"), (1e3, "compl")])
def test_reference_rejects_wrong_multipliers(solved, name, fault, number):
    """The solution with its inequality multipliers negated (wrong sign)
    or 1e3 times too large (not complementary) is rejected by that
    number."""
    cfg, ref, phase = solved[name]
    ans = answers(phase)
    ans["lamI"] = fault * ans["lamI"]
    lim = limits(name)
    c, ok = judge.checks(judge.readings(ref, cfg, ans, "cpu"), lim)
    assert not ok and c[number]["value"] > lim[number]


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails(solved, name):
    """The solution rounded to float32, its objective the reference's in
    float32, comes out not correct."""
    cfg, ref, phase = solved[name]
    ans = judge.control(ref, cfg, answers(phase), "cpu")
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
