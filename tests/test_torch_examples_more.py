"""The port's copies of the examples that `tests/test_examples_more.py`
holds to their cited or closed-form objectives, at that file's arguments,
with its assertions and bounds (its longer problems are in
`test_torch_examples_more_long.py`).

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

CONVERGED = 0


def solved(label):
    """The port's run of one example at its JAX test's arguments, held to
    the JAX package's; the numbers the test cites."""
    return example_held(tast, label)[0]


def test_analytic_example():
    """Closed-form LQR-like problem: collocation control and costates
    match the analytic optimum."""
    c = solved("AnalyticExample")
    assert c["uerr"] < 5e-3, c
    assert c["lerr"] < 5e-2, c


def test_bryson_denham():
    """Analytic objective 4/(9*l) = 4 at l = 1/9."""
    c = solved("BrysonDenham")
    assert abs(c["objective"] - 4.0) < 1e-2, c


def test_zermelo_no_wind():
    """No-wind minimum time = straight-line distance / speed."""
    c, solves = example_held(tast, "Zermelo")
    assert [s[0] for s in solves] == [CONVERGED], solves
    assert abs(c["time"] - 5.0 ** 0.5) < 1e-6, c


def test_zermelo_winds():
    """Wind-field variants converge with finite positive times."""
    c, solves = example_held(tast, "ZermeloWinds")
    assert [s[0] for s in solves] == [CONVERGED] * 2, solves
    assert 0 < c["time_uniform"] < 10 and 0 < c["time_variable"] < 10, c


def test_mountain_car():
    """dymos reference escape time ~103.  Chaotic: under 1e-10
    perturbations of its guess the JAX package ends CONVERGED or
    ACCEPTABLE between 103.14 and 104.28."""
    c = solved("MountainCar")
    assert abs(c["time"] - 103.0) < 3.0, c


def test_free_flying_robot():
    """arXiv:1905.11898 minimum-fuel objective J* ~= 7.910."""
    c = solved("FreeFlyingRobot")
    assert abs(c["objective"] - 7.910) < 0.05, c


def test_bike_obstacle():
    """Minimum transit time around the obstacle, its margin respected
    along the path."""
    c = solved("BikeObstacle")
    assert 4.8 < c["time"] < 5.3, c
    assert c["clearance"] > 7.49, c
