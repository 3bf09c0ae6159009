"""cartpole-lgl5: the cart-pole swing-up of ASSET's documentation
(`doc/examples/CartPole.rst`), the problem of Kelly, "An Introduction to
Trajectory Optimization", SIAM Review 59(4), 2017: a pendulum on a cart
driven by a bounded force swings up from hanging to upright in a fixed
time, with the integral of the squared force as the objective.

`build(ast, cfg)` poses it with the port's public API (`ast` is the
`asset_asrl_torch` namespace, passed in, so that this file imports no
part of the program); `reference/cartpole-lgl5.py` is its plain
reference.
"""

import numpy as np

SOURCE = "https://github.com/AlabamaASRL/asset_asrl/blob/master/doc/examples/CartPole.rst"

CONFIG = {
    "m1": 1.0,              # cart mass
    "m2": 0.3,              # pole mass
    "l": 0.5,               # pole length
    "g": 9.81,
    "d": 1.0,               # distance the cart travels
    "T": 2.0,               # fixed final time
    "u_max": 20.0,          # |force| bound
    "x_max": 2.0,           # |cart position| bound
    "transcription": "LGL5",
    "nsegs": 5000,          # 10,001 nodes
    "ig_points": 100,       # rows of the straight-line initial guess
    # the accuracy the solution is held to: PSIOPT's KKT (stationarity),
    # equality, inequality and barrier (complementarity) tolerances
    "tolerances": {"KKTtol": 1.0e-6, "EContol": 1.0e-6, "IContol": 1.0e-6,
                   "Bartol": 1.0e-6},
}

# keys cut in scale from the source: none (nsegs is raised, see ASSUMED)
REDUCED = []

# the keys of CONFIG a CPU test changes: a mesh the CPU solves in seconds
TEST_OVERRIDES = {"nsegs": 16}

ASSUMED = {
    "nsegs": "5000 segments (10,001 nodes; KKT blocks (K, W, b) = (5001, "
             "24, 2)) where the documentation solves 64 (28 ms on a "
             "6-core CPU, CartPole.rst:143): a mesh a user picks for "
             "accuracy, raised, not cut, to the 10k collocation nodes at "
             "which BASELINE.md states this repository's performance "
             "target, past the point where the documentation's KKT "
             "factorization stops scaling with threads (PSIOPT.rst:269)",
    "guess": "states and time on a straight line from start to goal over "
             "ig_points rows, force 0, as the documentation's guess",
}


def build(ast, cfg):
    """The transcribed phase (LGL5, default control mode)."""
    vf, oc = ast.VectorFunctions, ast.OptimalControl
    m1, m2, l, g = cfg["m1"], cfg["m2"], cfg["l"], cfg["g"]

    class CartPole(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(4, 1)
            x, th, xd, thd = XtU.XVec().tolist()
            F = XtU.UVar(0)
            Q = vf.stack([-g * vf.sin(th),
                          F + m2 * l * vf.sin(th) * thd ** 2])
            M = vf.RowMatrix(vf.stack(vf.cos(th), l, m1 + m2,
                                      m2 * l * vf.cos(th)), 2, 2)
            super().__init__(vf.stack([xd, thd, M.inverse() * Q]), 4, 1)

    tf, xf = cfg["T"], cfg["d"]
    ts = np.linspace(0, tf, cfg["ig_points"])
    IG = [[xf * t / tf, np.pi * t / tf, 0, 0, t, 0.0] for t in ts]
    phase = CartPole().phase(cfg["transcription"], IG, cfg["nsegs"])
    phase.addBoundaryValue("First", range(0, 5), [0, 0, 0, 0, 0])
    phase.addBoundaryValue("Last", range(0, 5), [xf, np.pi, 0, 0, tf])
    phase.addLUVarBound("Path", 5, -cfg["u_max"], cfg["u_max"])
    phase.addLUVarBound("Path", 0, -cfg["x_max"], cfg["x_max"])
    phase.addIntegralObjective(vf.Arguments(1)[0] ** 2, [5])
    phase.optimizer.set_tols(**cfg["tolerances"])
    phase.transcribe()
    return phase
