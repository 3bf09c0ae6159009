"""`tests/test_fullproblems2.py` on the port: VanDerPol, the Goddard
rocket as one phase and as three (the singular-arc path constraint), and
the multi-phase cannon with a linked ODE parameter.  The JAX tests build
the problems of `examples/VanDerPol.py`, `GoddardRocket.py` and
`MultiPhaseCannon.py` line for line, so these run the port's copies of
those scripts, with the JAX tests' assertions and bounds.

Each solve is also held to the JAX package's run of the same script
(`chip_smoke.EXAMPLES_JAX`, from `python tools/port_references.py
--examples`): the flags, and the objectives to 1e-9 relative.  Not the
iteration counts: the three-phase Goddard and the cannon are chaotic in
the reference itself (ROADMAP queue 3: a 1e-10 perturbation of the guess
moves either package's count by up to tens of iterations), while the
optimum they reach agrees to 1e-9.  `test_torch_examples_jax.py` holds
those constants to the JAX scripts."""

import numpy as np
import torch

import asset_asrl_torch as tast
from asset_asrl_torch.examples.GoddardRocket import Lstar
from chip_smoke import EXAMPLES_JAX, example_faults, example_held, solve_log

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
tast.config.use_device("cpu")


def test_vanderpol():
    c = example_held(tast, "VanDerPol", size="full", tol=1e-9)[0]
    # dymos reference objective for this configuration is ~2.87
    assert abs(c["objective"] - 2.87) < 0.1, c


def goddard(formulation):
    """One of the two Goddard solves from the example's burn-until-empty
    guess: (its trajectory, its solve log)."""
    from asset_asrl_torch.examples import GoddardRocket as G
    vf = tast.VectorFunctions
    ode = G.GoddardRocket()
    ulaw = vf.ifelse(vf.Arguments(1)[0] > G.mf, 1, 0)
    integ = ode.integrator(.01, ulaw, [2])
    X0 = np.zeros(5)
    X0[2] = G.m0
    X0[4] = 1
    TrajIG = integ.integrate_dense(X0, 60 / G.Tstar, 500, lambda x: x[1] < 0)
    with solve_log(tast) as log:
        T = getattr(G, formulation)(ode, TrajIG)
    return np.asarray(T), log


def held(log, which):
    # the script's first solve is the single phase, its second the three
    flags, objs = EXAMPLES_JAX["GoddardRocket full"]
    bad = example_faults(None, {}, log, ([flags[which]], [objs[which]]),
                         tol=1e-9)
    assert not bad, bad


def test_goddard_single_phase():
    T, log = goddard("single_phase")
    held(log, 0)
    hf = T[-1][0] * Lstar
    # regression value cross-validated against the multi-phase formulation
    assert abs(hf - 18727.8) < 20, hf


def test_goddard_multiphase():
    T, log = goddard("multi_phase")
    held(log, 1)
    hf = T[-1][0] * Lstar
    assert abs(hf - 18727.8) < 20, hf
    # continuity across links: the three phases have 24 segments each, so
    # a third of the rows each; phase 1's last row into phase 2's first
    k = len(T) // 3
    assert np.allclose(T[k - 1][:4], T[k][:4], atol=1e-6)


def test_multiphase_cannon():
    c = example_held(tast, "MultiPhaseCannon", size="full",
                     tol=1e-9)[0]
    assert abs(c["range"] - 3280.2) < 25, c
    assert abs(c["radius"] - 0.04195) < 5e-3, c
    # ODE param linked across phases
    assert c["param_link"] < 1e-10, c
