"""The port's copies of the `examples/UpdatedInterface/` variants (the
named-variable Vgroups API, make_input/make_units, setUnits-based
auto-scaling) that `tests/test_updated_interface.py` holds to their base
examples' objectives, at that file's arguments, with its assertions and
bounds (its reentry and Delta III are in
`test_torch_updated_interface_long.py`).

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

The Betts mirror takes 12 minutes on the CPU and is `slow` too."""

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


def test_ui_goddard_rocket():
    """Named-variable Goddard: single-phase and 3-phase singular arc
    agree."""
    c = solved("UpdatedInterface.GoddardRocket")
    assert abs(c["h_single"] - 18728.0) < 30.0, c
    assert abs(c["h_single"] - c["h_three"]) < 0.5, c


def test_ui_multiphase_cannon():
    """Cannonball with a linked ODE-parameter radius: range 3.280 km,
    landing at h = 0."""
    c = solved("UpdatedInterface.MultiPhaseCannon")
    assert abs(c["range"] - 3.280) < 0.05, c
    assert c["landing_h"] < 1e-8, c


def test_ui_minimum_time_to_climb():
    c = solved("UpdatedInterface.MinimumTimeToClimb")
    assert abs(c["t_climb"] - 324.0) < 8.0, c


@pytest.mark.slow
def test_ui_betts_low_thrust():
    """Adaptive: held to the last flag, not to the objective.  About 12
    min on an 8-core CPU (the integrator)."""
    c = solved("UpdatedInterface.BettsLowThrust")
    assert abs(c["final_weight"] - 0.220179) < 2e-4, c
