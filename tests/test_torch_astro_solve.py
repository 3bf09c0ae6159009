"""One solve of the Astro slice in both packages: the mass-optimal Earth to
Dionysus low-thrust transfer of `examples/DionysusLowThrust.py`
(`chip_smoke.build_dionysus`: MEE dynamics with a constant-specific-impulse
thruster, LGL5, block-constant controls) at 16 segments under each
package's default solve.

The port's solve is held to the JAX package's (`DIONYSUS_16`): the flag,
the final mass and the objective to 1e-9 relative, and the trajectory at
five nodes to 1e-6.  The JAX solve itself (about 55 s on the CPU, most of
it compiling) runs in the `slow` test, which holds the constants to it
and compares every node; tier-1 reads the constants.  The iteration count
is not held: it turns on rounding, the JAX package takes 109 iterations
and the port 108 at 16 segments (118 and 120 at 24), and a relative
perturbation of 1e-10 of the initial guess moves each package's own
count by more than that (ROADMAP queue 3)."""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from chip_smoke import DIONYSUS_MASS, build_dionysus

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

NSEGS = 16
# The JAX package's default solve of the transfer at NSEGS segments
# (`python tools/port_references.py --dionysus-16`): flag, iterations,
# final mass in kg, objective, and the trajectory rows of `REF_NODES`
DIONYSUS_16 = (0, 109, 2453.24366236244, -0.61331091559061)
REF_NODES = (0, 8, 16, 24, 32)
DIONYSUS_16_ROWS = np.array([
    [0.99969, -0.00376, 0.01628, -7.702000000000002e-06,
     6.18799999999998e-07, 14.161, 1.0, -1.7526508069182191e-22,
     -0.17611251577205675, 0.9682892479664035, -0.17720133619843445],
    [1.2915177251281582, -0.07781061805648923, -0.058100651597887444,
     0.0080499929562468, 0.0036800932716824154, 26.392622621327355,
     0.8774642815284128, 15.198054420954245, -8.066196057017087e-07,
     5.657726597909873e-07, 1.7159704517593086e-07],
    [1.4764793033260548, -0.025660776475416324, -0.15130618236422522,
     0.006397531181581217, 0.005566789525289123, 35.23111596615475,
     0.8255711756439656, 30.39610884190849, 0.13280251722475453,
     0.9814015559772022, -0.13861629441046086],
    [1.3919787707186924, 0.0355754675243286, -0.39560029835927696,
     -0.0012185277331222732, 0.045105460972299616, 41.764850123307106,
     0.7217851715130841, 45.594163262862736, 0.3287854828481323,
     0.9402938677484922, 0.08802015891658285],
    [1.5536, 0.15303, -0.51994, 0.01618, 0.11814, 46.3302,
     0.61331091559061, 60.79221768381698, -0.13461412354534874,
     -0.0006794130158797399, 0.09115149599809726],
])


def solved(ast):
    ph = build_dionysus(ast, NSEGS)
    ph.optimizer.set_PrintLevel(3)
    flag = ph.optimize()
    traj = np.asarray(ph.returnTraj())
    return flag, ph.optimizer, traj


@pytest.fixture(scope="module")
def port():
    return solved(tast)


def matches_reference(flag, opt, traj):
    """flag, final mass and objective of a solve against `DIONYSUS_16`."""
    rflag, _, rmass, robj = DIONYSUS_16
    mass = traj[-1, 6] * DIONYSUS_MASS
    assert flag == rflag == 0
    assert abs(mass - rmass) <= 1e-9 * rmass, (mass, rmass)
    assert abs(opt.LastObjVal - robj) <= 1e-9 * abs(robj)


def test_dionysus_flag_and_mass_match_jax(port):
    tflag, topt, ttraj = port
    assert topt.UseFused and topt.InitLmults
    matches_reference(tflag, topt, ttraj)


def test_dionysus_trajectory_matches_jax(port):
    """The converged trajectory agrees with JAX's at the reference nodes
    (states, time and controls) and holds the boundary conditions."""
    ttraj = port[2]
    assert ttraj.shape == (NSEGS * 2 + 1, 11)
    assert np.abs(ttraj[list(REF_NODES)] - DIONYSUS_16_ROWS).max() <= 1e-6
    X0 = np.array([0.99969, -0.00376, 0.01628, -7.702e-6, 6.188e-7, 14.161])
    XF = np.array([1.5536, 0.15303, -0.51994, 0.01618, 0.11814, 46.3302])
    assert np.abs(ttraj[0, :6] - X0).max() <= 1e-9
    assert np.abs(ttraj[-1, :6] - XF).max() <= 1e-9
    assert (np.linalg.norm(ttraj[:, 8:11], axis=1) <= 1 + 1e-6).all()


@pytest.mark.slow
def test_dionysus_reference_is_the_jax_solve(port):
    """The JAX package's solve, run here: it gives `DIONYSUS_16` (flag,
    mass and objective to 1e-9, the reference nodes to 1e-12), and the
    port's trajectory agrees with it at every node to 1e-6."""
    jflag, jopt, jtraj = solved(jast)
    matches_reference(jflag, jopt, jtraj)
    assert np.abs(jtraj[list(REF_NODES)] - DIONYSUS_16_ROWS).max() <= 1e-12
    assert np.abs(port[2] - jtraj).max() <= 1e-6
