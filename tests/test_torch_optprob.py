"""The port's generic problems and Jet runner: `OptimizationProblem`
(dense KKT, host loop) against the JAX package on the Rosenbrock problem
of `tests/test_fullproblems.py`, and `Jet.map` against the same problems
solved one after another."""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from test_torch_parallel import double_integrator

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


def rosenbrock(ast, lsmode):
    """`tests/test_fullproblems.py::test_rosenbrock`: the Rosenbrock
    function inside the disk x^2 + y^2 <= 2, from (-1, -1)."""
    vf = ast.VectorFunctions
    xy = vf.Arguments(2)
    prob = ast.Solvers.OptimizationProblem()
    prob.setVars([-1, -1])
    prob.addObjective((1 - xy[0]) ** 2 + 100 * (xy[1] - xy[0] ** 2) ** 2,
                      [0, 1])
    prob.addInequalCon(vf.Arguments(2).squared_norm() - 2.0, [0, 1])
    prob.optimizer.set_OptLSMode(lsmode)
    prob.optimizer.PrintLevel = 3
    return prob


@pytest.mark.parametrize("lsmode", ["NOLS", "AUGLANG", "L1"])
def test_rosenbrock_matches_jax(lsmode):
    pj, pt = rosenbrock(jast, lsmode), rosenbrock(tast, lsmode)
    fj, ft = pj.optimize(), pt.optimize()
    assert ft == fj == 0
    assert pt.optimizer.LastIterNum == pj.optimizer.LastIterNum < 30
    assert np.abs(pt.returnVars() - pj.returnVars()).max() <= 1e-8
    assert np.linalg.norm(pt.returnVars() - [1, 1]) < 1e-5


def test_optimization_problem_api():
    prob = tast.Solvers.OptimizationProblem()
    vf = tast.VectorFunctions
    with pytest.raises(ValueError):
        prob.optimize()                       # no variables yet
    with pytest.raises(ValueError):
        prob.addObjective(vf.Arguments(2), [0, 1])   # not scalar
    with pytest.raises(ValueError):
        prob.addEqualCon(vf.Arguments(2).norm() - 1, [0, 1, 2])
    prob = rosenbrock(tast, "NOLS")
    prob.setJetJobMode("solve_optimize")
    prob.setThreads(4)
    assert prob.jet_run() == 0 and prob.numVars() == 2


def test_jet_map_matches_sequential():
    """Three phases through `Jet.map` (`nthreads=2`, accepted for the JAX
    package's signature; the solves run in turn): every flag, iteration
    count and solution equal to the same phases solved one after
    another."""
    finals = (0.8, 1.0, 1.2)
    seq = []
    for xf in finals:
        p = double_integrator(tast, 8, xf)
        seq.append((p.optimize(), p.optimizer.LastIterNum,
                    p.makeSolverInput()))
    probs = tast.Solvers.Jet.map(
        lambda xf: double_integrator(tast, 8, xf), finals, nthreads=2)
    assert len(probs) == 3
    for p, (flag, iters, x) in zip(probs, seq):
        assert p.optimizer.ConvergeFlag == flag == 0
        assert p.optimizer.LastIterNum == iters
        assert np.abs(p.makeSolverInput() - x).max() <= 1e-12
    built = [double_integrator(tast, 8, xf) for xf in finals]
    assert tast.Solvers.Jet.map(built, None, 1, jobmode="optimize") == built
