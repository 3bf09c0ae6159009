"""The slice end to end: CartPole swing-up through the port's
`phase.optimize()` against the JAX package's host loop (CPU path)."""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from chip_smoke import OBJ_40, build_cartpole

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

CONVERGED = tast.Solvers.ConvergenceFlags.CONVERGED


@pytest.fixture(scope="module")
def solved40():
    pt = build_cartpole(tast, 40)
    pt.optimizer.set_PrintLevel(2)
    pt.optimizer.UseFused = False       # held to the JAX host loop
    flag = pt.optimize()
    return pt, flag


def test_cartpole_40_flag_iters_objective(solved40):
    pt, flag = solved40
    assert flag == CONVERGED
    assert pt.optimizer.LastIterNum == 10
    assert abs(pt.optimizer.LastObjVal - OBJ_40) <= 1e-8 * OBJ_40


def test_cartpole_40_matches_jax_host_loop(solved40):
    pt, _ = solved40
    pj = build_cartpole(jast, 40)
    pj.optimizer.set_PrintLevel(2)
    pj.optimizer.UseFused = False
    assert pj.optimize() == CONVERGED
    assert pj.optimizer.LastIterNum == pt.optimizer.LastIterNum
    xj, xt = pj.makeSolverInput(), pt.makeSolverInput()
    assert np.abs(xt - xj).max() <= 1e-6 * max(1.0, np.abs(xj).max())
    assert np.abs(np.asarray(pt.returnTraj())
                  - np.asarray(pj.returnTraj())).max() < 1e-6


@pytest.mark.parametrize("tmode,nsegs", [("LGL5", 128), ("LGL7", 96)])
def test_cartpole_default_control_mode(tmode, nsegs):
    """test_fullproblems.test_cartpole's transcriptions and segment counts,
    in the default (FirstOrderSpline) control mode."""
    pt = build_cartpole(tast, nsegs, tmode)
    pt.optimizer.set_PrintLevel(2)
    assert pt.optimize() == CONVERGED
    assert pt.optimizer.LastIterNum <= 20
    assert abs(pt.optimizer.LastObjVal - 58.83219229674185) < 0.1
