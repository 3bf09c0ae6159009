"""asset_asrl_torch.Astro: the ported part of the astrodynamics layer
(classical-element conversions; the rest waits, ROADMAP queue 1)."""

from .kepler import (cartesian_to_classic, classic_to_cartesian,
                     true_to_mean_anomaly, mean_to_true_anomaly)
