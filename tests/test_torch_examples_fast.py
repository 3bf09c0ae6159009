"""The port's copies of the examples of `tests/test_examples_fast.py`, at
that file's arguments, with its assertions and bounds (its low-thrust
raising is in `test_torch_examples_fast_lowthrust.py`, a file of its own
so that test workers can take it apart from these).

Each is also held to the JAX package's run of the same script at the
same arguments (`chip_smoke.EXAMPLES_JAX`, from `python
tools/port_references.py --examples`): every solve's flag, and the
objective of every solve that optimizes to 1e-8 relative (absolute below
1).  Iteration counts are not held: several of these problems turn on
rounding (ROADMAP queue 3).  An adaptive run is held to its last flag,
and one that `chip_smoke.EXAMPLES` marks with `rounding` to the flags
and the spread that the JAX package itself shows when its starting point
moves by 1e-10 (`tools/perturbed_examples.py`).
`test_torch_examples_jax.py` holds those constants to the JAX scripts.

The parking, docking, heteroclinic and Betts mirrors take minutes on
the CPU (the Betts transfer 12) and are `slow` too."""

import pytest
import torch

import asset_asrl_torch as tast
from chip_smoke import example_held

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
tast.config.use_device("cpu")

CONVERGED = 0


def solved(label):
    """The port's run of one example at its JAX test's arguments, held to
    the JAX package's; the numbers the test cites."""
    return example_held(tast, label)[0]


def test_multiphase_zermelo():
    """Two linked legs under an adverse uniform wind: total time 3.2356,
    waypoints hit, time chained continuously."""
    c, solves = example_held(tast, "MultiPhaseZermelo")
    assert [s[0] for s in solves] == [CONVERGED], solves
    assert abs(c["time"] - 3.2356) < 0.05, c
    assert c["waypoints"] < 1e-6, c


def test_dionysus():
    """Junkins & Taheri mass-optimal Earth->Dionysus at 150 segments:
    final mass above 2700 kg (global optimum ~2718 kg)."""
    c = solved("DionysusLowThrust")
    assert c["final_mass"] > 2700, c


@pytest.mark.slow
def test_parallel_parking():
    """Li/Wang/Chu 2016 case 7: maneuver time 18.426 s; ours within 1%.
    Chaotic in its second solve.  About 4 min on an 8-core CPU."""
    c = solved("ParallelParking")
    assert abs(c["time"] - 18.426) < 0.4, c


@pytest.mark.slow
def test_optimal_docking_form2():
    """About 4.5-7.5 min on an 8-core CPU."""
    c = solved("OptimalDocking")
    assert 120 < c["final_time"] < 260, c


@pytest.mark.slow
def test_heteroclinic():
    """CR3BP L1->L2 heteroclinic connection at the full manifold
    resolution (nman=40): the matched connection needs under 10 m/s.
    Its objective, a velocity mismatch, converges to ~2.5e-9.  About
    3.5 min on an 8-core CPU."""
    c = solved("Heteroclinic")
    assert c["dv"] < 10.0, c


@pytest.mark.slow
def test_betts_low_thrust():
    """Betts example 6 (LEO->MEO zonal-harmonics low thrust): final
    weight ~0.220179 lb.  Adaptive: held to the last flag, not to the
    objective.  About 12 min on an 8-core CPU (the integrator)."""
    c = solved("BettsLowThrust")
    assert abs(c["final_weight"] - 0.220179) < 2e-4, c
