"""The longer problems of `tests/test_examples_more.py` on the port's
copies, at that file's arguments, with its assertions and bounds: a
file apart from `test_torch_examples_more.py` so that test workers can
take them apart.

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

The TopputtoLowThrust and HangingChain mirrors take minutes on the
CPU and are `slow` too."""

import pytest
import torch

import asset_asrl_torch as tast
from chip_smoke import example_held

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
tast.config.use_device("cpu")


def solved(label):
    """The port's run of one example at its JAX test's arguments, held to
    the JAX package's; the numbers the test cites."""
    return example_held(tast, label)[0]


def test_minimum_time_to_climb():
    """Bryson 1969 / ICLOCS2 supersonic climb: ~324 s minimum time."""
    c = solved("MinimumTimeToClimb")
    assert abs(c["t_climb"] - 324.0) < 8.0, c


def test_orbit_continuation():
    """CR3BP L1 Lyapunov family: each continuation step re-solves the
    periodicity system through subVariables."""
    c = solved("OrbitContinuation")
    assert c["orbits"] >= 3, c
    assert c["periodicity"] < 1e-8, c


@pytest.mark.slow
def test_topputto_low_thrust():
    """Planar r=1 -> r=4 raising: time-optimal tof 55.55, fuel-optimal
    tof ~115.8 ending in a coast.  Chaotic in its third solve (the JAX
    package's objective moves by 2e-4 under 1e-10 perturbations).  About
    3.5 min on an 8-core CPU."""
    c = solved("TopputtoLowThrust")
    assert abs(c["tof"] - 55.55) < 1.0, c
    assert abs(c["tof_mass"] - 115.8) < 3.0, c
    assert c["throttle"] < 0.01, c


@pytest.mark.slow
def test_hanging_chain_jet():
    """Catenary family through `Jet.map`: the chains converge and hang
    between the anchors, the long ones sagging below anchor a.  The
    shortest chain is chaotic (JAX: CONVERGED or NOTCONVERGED under
    1e-10 perturbations).  About 1.7 min on an 8-core CPU."""
    c = solved("HangingChain")
    assert c["converged"] >= 3, c
    assert c["anchors"] < 1e-6, c
    assert c["sag"] < 0.0, c
