"""The reentry and Delta III of `tests/test_updated_interface.py` on the
port's copies of `examples/UpdatedInterface/`, at that file's arguments,
with its assertions and bounds: a file apart from
`test_torch_updated_interface.py` so that test workers can take them
apart.

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


def test_ui_reentry():
    """Named-variable shuttle reentry: crossrange 0.59588 rad (Betts)."""
    c = solved("UpdatedInterface.Reentry")
    assert abs(c["crossrange"] - 0.5958800738629952) < 2e-3, c


def test_ui_delta3_launch():
    """Named-variable Delta III on the adaptive mesh: final mass
    7529.7499 kg; held to the last flag, not to the objective."""
    c = solved("UpdatedInterface.Delta3Launch")
    assert abs(c["final_mass"] - 7529.7499) < 1.0, c
