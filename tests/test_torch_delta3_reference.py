"""The benchmark's Delta III configuration (`portbench/configs/delta3-lgl3.py`)
at its CPU test mesh, reached only through the `ocp_solve` entry's
Driver: the plain reference (`portbench/reference/delta3-lgl3.py`) states
the port's NLP, one `solve_optimize()` from the published guess converges
within its cell's limits by the benchmark's judge, and
PSIOPT's stats sum the solve's two passes.  Also that the configuration
poses the port's published example, and that a one-pass solve keeps the
fused loop's own stats."""

import numpy as np
import pytest
import torch

import asset_asrl_torch as tast
from asset_asrl_torch.examples import Delta3Launch
from chip_smoke import build_brachistochrone
from portbench import judge, spec

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

CONFIG = spec.load_module("configs", "delta3-lgl3")
CFG = dict(CONFIG.CONFIG, **CONFIG.TEST_OVERRIDES)
REF = spec.load_module("reference", "delta3-lgl3")


@pytest.fixture(scope="module")
def solved():
    """(driver, the unit's answers) after one unit from the base."""
    entry = spec.load_module("entries", "ocp_solve")
    d = entry.Driver(tast, CONFIG, CFG, {"perturb": "relative",
                                         "scale": 1e-3, "lanes": 1})
    return d, d.unit(d.base[None])


def _point(d, out, which):
    if which == "solved":
        return out["x"][0]
    rng = np.random.default_rng(which)
    return d.base * (1.0 + 1e-3 * rng.standard_normal(d.base.size))


@pytest.mark.parametrize("which", ["solved", 1, 2, 3])
def test_reference_states_the_nlp(solved, which):
    """Objective, equalities and inequalities, row for row, to 1e-12 at
    the solved answer and at three perturbed guesses."""
    d, out = solved
    x = _point(d, out, which)
    obj, eq, iq = REF.problem(CFG, torch.tensor(x[None]))
    pobj, peq, piq = d.nlp.eval_obj_cons(torch.tensor(x))
    assert eq.shape == (1, d.nlp.numEq) and iq.shape == (1, d.nlp.numIq)
    assert float((eq[0] - peq).abs().max()) <= 1e-12
    assert float((iq[0] - piq).abs().max()) <= 1e-12
    assert abs(float(obj[0] - pobj)) <= 1e-12


def test_unit_converges_within_the_limits(solved):
    """The judge's six readings of the answer within the limits of the
    configuration's cell (`portbench/workloads/delta3-lgl3.solve-optimize
    .json`): feasibility within 3e-8 (EContol / IContol 1e-8; an answer
    rounded to float32 reads 1e-7 or more), the gradient of the
    Lagrangian within 1.2e-6 (KKTtol 1e-6), complementarity within 3e-9,
    the reported objective the reference's, the multipliers' signs and
    the flag exact."""
    d, out = solved
    assert int(out["flag"][0]) == 0
    ans = {k: np.asarray(out[k]) for k in ("x", "lamE", "lamI", "obj",
                                           "flag")}
    ans["sigma"] = d.sigma
    limits = spec.workload("delta3-lgl3.solve-optimize")["limits"]
    checks, ok = judge.checks(judge.readings(REF, CFG, ans, "cpu"), limits)
    assert ok, checks
    tol = CFG["tolerances"]
    assert checks["feas"]["value"] <= max(tol["EContol"], tol["IContol"])


def test_stats_sum_both_passes(solved):
    """solve_optimize runs an SOE pass, then an OPT pass: the counters sum
    both, the SOE pass's own are kept apart, and the unit's stats add the
    problem's host seconds around the optimizer."""
    d, out = solved
    opt, st = d.optimizer, out["stats"]
    assert st["iterations"] == opt.LastIterNum == int(out["iters"][0])
    assert st["passes"] == 2
    assert 0 < st["soe_iterations"] < st["iterations"]
    assert 0 < st["soe_s"] < st["loop_s"] <= st["run_s"] \
        == opt.LastTotalTime
    assert st["ad_eager"] >= st["iterations"]          # no graph on the CPU
    assert st["transcribe_s"] > 0 and st["io_s"] > 0


def test_config_poses_the_published_example(solved):
    """build() is the port's copy of upstream's example at the test mesh
    with the configuration's line searches and tolerances, and refuses a
    transcription the example does not pose."""
    d, _ = solved
    ex = Delta3Launch.build_ocp(CFG["nsegs"])
    ex.transcribe()
    assert np.array_equal(ex.makeSolverInput(), d.base)
    opt, tol = d.optimizer, CFG["tolerances"]
    assert (opt.OptLSMode, opt.SoeLSMode, opt.MaxLSIters) \
        == (CFG["ls_mode"], CFG["ls_mode"], CFG["MaxLSIters"])
    assert {k: getattr(opt, k) for k in tol} == tol
    with pytest.raises(ValueError):
        CONFIG.build(tast, dict(CFG, transcription="LGL5"))


def test_one_pass_keeps_the_loop_stats():
    """`Phase.optimize()` is one fused pass: its LastFusedStats are the
    loop's own counters, with only the summary keys added."""
    p = build_brachistochrone(tast, "LGL3", 8)
    opt = p.optimizer
    opt.set_PrintLevel(3)
    assert p.optimize() == 0
    st, own = opt.LastFusedStats, opt._fused_cache[1].stats
    assert set(st) - set(own) == {"passes", "soe_iterations", "soe_s",
                                  "run_s"}
    assert {k: st[k] for k in own} == own
    assert (st["passes"], st["soe_iterations"], st["soe_s"]) == (1, 0, 0.0)
    assert st["iterations"] == opt.LastIterNum
    assert st["run_s"] == opt.LastTotalTime
