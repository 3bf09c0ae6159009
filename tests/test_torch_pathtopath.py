"""`tests/test_pathtopath.py::test_pathtopath_direct_link` on the port:
formation flying of two double integrators, phase B held at a fixed
offset from phase A at every collocation node by a PathToPath direct
link (the JAX file's other two tests are mirrored in
`test_torch_ocp.py`).  The port's solve is held to the JAX package's
(`JAX_LINK`: flag and objective to 1e-8 relative); the `slow` test runs
the JAX solve here and holds the constant to it."""

import numpy as np
import pytest
import torch

import asset_asrl_torch as tast

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
tast.config.use_device("cpu")

# the JAX package's solve of `linked` (x64, CPU; the `slow` test): flag,
# objective
JAX_LINK = (0, 3.08847184948195)


def _phase(ast, x0, xf, nsegs=8):
    vf, oc = ast.VectorFunctions, ast.OptimalControl

    class DI(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    ts = np.linspace(0, 2, 20)
    IG = [[x0 + (xf - x0) * t / 2, (xf - x0) / 2, t, 0.0] for t in ts]
    ph = DI().phase("LGL3", IG, nsegs)
    ph.addBoundaryValue("Front", [0, 1, 2], [x0, 0, 0])
    ph.addBoundaryValue("Back", [0, 1, 2], [xf, 0, 2])
    ph.addIntegralObjective(vf.Arguments(1)[0] ** 2, [3])
    return ph


def linked(ast):
    """The test's problem in package `ast`: (flag, objective, the two
    phases' trajectories)."""
    pa = _phase(ast, 0.0, 1.0)
    pb = _phase(ast, 0.2, 1.2)
    ocp = ast.OptimalControl.OptimalControlProblem()
    ocp.addPhase(pa)
    ocp.addPhase(pb)
    # xB(t_j) - xA(t_j) = 0.2 for every node j
    A = ast.VectorFunctions.Arguments(2)
    ocp.addDirectLinkEqualCon(A[0] - A[1] + 0.2, pa, "Path", [0],
                              pb, "Path", [0])
    ocp.optimizer.set_PrintLevel(2)
    flag = ocp.optimize()
    return (flag, ocp.optimizer.LastObjVal, np.asarray(pa.returnTraj()),
            np.asarray(pb.returnTraj()))


def test_pathtopath_direct_link():
    """Phase B shadows phase A at a fixed offset at every node."""
    flag, obj, ta, tb = linked(tast)
    assert flag == 0, flag
    assert np.allclose(tb[:, 0] - ta[:, 0], 0.2, atol=1e-6)
    assert (flag, obj) == (JAX_LINK[0], pytest.approx(JAX_LINK[1], rel=1e-8))


@pytest.mark.slow
def test_reference_is_the_jax_solve():
    import asset_asrl_tpu as jast
    flag, obj, _, _ = linked(jast)
    assert (flag, obj) == (JAX_LINK[0], pytest.approx(JAX_LINK[1], rel=1e-9))
