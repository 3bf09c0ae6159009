"""J2 oblateness perturbation models.

Port of `asset_asrl_tpu/Astro/J2.py` (reference `src/Astro/J2.h:5-39`:
J2Cartesian, the acceleration from the position relative to the body and
the body's north-pole unit vector; the reference's J2Modified is
unfinished upstream and built here through the MEE to cartesian
conversion).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..VectorFunctions.function import VectorFunction
from .kepler import _cross, _modified_to_cart

__all__ = ["J2Cartesian", "J2Modified"]


def J2Cartesian(mu, J2, Rb):
    """VectorFunction [r (3), p (3)] -> acceleration (3).

    r: position relative to the body; p: body north-pole vector
    (normalized internally).  Matches `J2Cartesian_Impl::Definition`
    (`src/Astro/J2.h:14-33`):
        a = 0.5 mu J2 Rb^2 [ (15 (r_hat.p_hat)^2 - 3) r/|r|^5
                             - 6 (r.p_hat/|r|^5) p_hat ]
    """
    scale = 0.5 * float(mu) * float(J2) * float(Rb) ** 2

    def impl(x):
        r = x[:3]
        p = x[3:6]
        p = p / torch.sqrt(p @ p)
        rn2 = r @ r
        rn = torch.sqrt(rn2)
        rn5 = r / (rn2 * rn2 * rn)             # r / |r|^5
        dott = ((r / rn) @ p) ** 2
        term1 = (15.0 * dott - 3.0) * rn5
        term2 = -6.0 * (rn5 @ p) * p
        return scale * (term1 + term2)

    return VectorFunction(impl, 6, 3, name="J2Cartesian")


def J2Modified(mu, J2, Rb, pole=(0.0, 0.0, 1.0)):
    """VectorFunction [p, f, g, h, k, L] -> RTN J2 perturbation (3).

    Converts the MEE state to cartesian, evaluates J2Cartesian against a
    fixed pole, and rotates into the RTN frame (the input frame of the MEE
    dynamics' perturbation slot, `src/Astro/MEEDynamics.h`)."""
    scale = 0.5 * float(mu) * float(J2) * float(Rb) ** 2
    pole = np.asarray(pole, dtype=np.float64)
    pole = config.tensor(pole / np.linalg.norm(pole))

    def impl(x):
        rv = _modified_to_cart(x, mu)
        r = rv[:3]
        v = rv[3:6]
        p = pole
        rn2 = r @ r
        rn = torch.sqrt(rn2)
        rn5 = r / (rn2 * rn2 * rn)
        dott = ((r / rn) @ p) ** 2
        acc = scale * ((15.0 * dott - 3.0) * rn5 - 6.0 * (rn5 @ p) * p)
        # RTN basis
        rhat = r / rn
        hvec = _cross(r, v)
        nhat = hvec / torch.sqrt(hvec @ hvec)
        that = _cross(nhat, rhat)
        return torch.stack([acc @ rhat, acc @ that, acc @ nhat])

    return VectorFunction(impl, 6, 3, name="J2Modified")
