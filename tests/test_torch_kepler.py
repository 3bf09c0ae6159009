"""Classical-element conversions (`asset_asrl_torch.Astro`) against the
JAX package's `asset_asrl_tpu.Astro.kepler` on seeded elliptic orbits,
to 1e-12 relative, and the Delta III target state of `tests/test_delta3.py`.
"""

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast

torch.set_num_threads(2)


def orbits(seed, n=6):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(1.1, 4.0, n),          # a
                     rng.uniform(0.01, 0.9, n),         # e
                     rng.uniform(0.05, 3.0, n),         # i
                     rng.uniform(0.0, 2 * np.pi, n),    # RAAN
                     rng.uniform(0.0, 2 * np.pi, n),    # argp
                     rng.uniform(-np.pi, np.pi, n)],    # mean anomaly
                    axis=1)


def rel(a, b):
    return np.abs(a - b).max() / max(1.0, np.abs(a).max())


@pytest.mark.parametrize("mu", [1.0, 398600.4418])
def test_classic_to_cartesian(mu):
    for oe in orbits(1):
        oe = oe * np.array([1.0 if mu == 1.0 else 7000.0, 1, 1, 1, 1, 1])
        a = jast.Astro.classic_to_cartesian(oe, mu)
        b = tast.Astro.classic_to_cartesian(oe, mu)
        assert rel(a, b) <= 1e-12


def test_cartesian_to_classic_and_round_trip():
    for oe in orbits(2):
        rv = jast.Astro.classic_to_cartesian(oe, 1.0)
        a = jast.Astro.cartesian_to_classic(rv, 1.0)
        b = tast.Astro.cartesian_to_classic(rv, 1.0)
        assert rel(a, b) <= 1e-12
        back = tast.Astro.classic_to_cartesian(b, 1.0)
        assert rel(rv, back) <= 1e-10


def test_anomalies():
    from asset_asrl_tpu.Astro import kepler as jk
    for ta, e in [(0.3, 0.1), (2.9, 0.7), (-1.2, 0.4)]:
        assert abs(jk.true_to_mean_anomaly(ta, e)
                   - tast.Astro.true_to_mean_anomaly(ta, e)) <= 1e-13
        M = jk.true_to_mean_anomaly(ta, e)
        assert abs(jk.mean_to_true_anomaly(M, e)
                   - tast.Astro.mean_to_true_anomaly(M, e)) <= 1e-13


def test_delta3_target_state():
    """The final state of Delta III's initial guess (canonical units)."""
    Lstar, Tstar = 6378145, 961.0
    mu = 3.986012e14 / (Lstar ** 3 / Tstar ** 2)
    oe = [24361140 / Lstar, .7308, np.deg2rad(28.5), np.deg2rad(269.8),
          np.deg2rad(130.5), -.05]
    a = jast.Astro.classic_to_cartesian(oe, mu)
    b = tast.Astro.classic_to_cartesian(oe, mu)
    assert rel(a, b) <= 1e-12
