"""The port's copy of the time-optimal low-thrust raising of
`tests/test_examples_fast.py::test_simple_low_thrust`, at that test's
arguments (64 segments) and with its bound; a file of its own, one of
the longest of the example mirrors, so that test workers can take it
apart from the others.

Each is also held to the JAX package's run of the same script at the
same arguments (`chip_smoke.EXAMPLES_JAX`, from `python
tools/port_references.py --examples`): every solve's flag, and the
objective of every solve that optimizes to 1e-8 relative (absolute below
1).  Iteration counts are not held: several of these problems turn on
rounding (ROADMAP queue 3).  An adaptive run is held to its last flag,
and one that `chip_smoke.EXAMPLES` marks with `rounding` to the flags
and the spread that the JAX package itself shows when its starting point
moves by 1e-10 (`tools/perturbed_examples.py`).
`test_torch_examples_jax.py` holds those constants to the JAX scripts."""

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


def test_simple_low_thrust():
    """Time-optimal r=1 -> r=2 raising at a=0.02: tof ~= 18.3 canonical
    units; then the power- and mass-optimal solves from it (the last
    ends ACCEPTABLE in both packages)."""
    c = solved("SimpleLowThrust")
    assert abs(c["tof"] - 18.27) < 0.3, c
