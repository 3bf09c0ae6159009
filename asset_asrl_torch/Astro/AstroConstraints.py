"""Common astrodynamics constraint builders.

The reference ships `asset_asrl/Astro/AstroConstraints.py` as an
import-only stub (5 lines); this module carries the constraint
expressions its examples build inline, as reusable VectorFunctions.

Port of `asset_asrl_tpu/Astro/AstroConstraints.py`.
"""

from __future__ import annotations

import numpy as np

from .. import VectorFunctions as vf

Args = vf.Arguments

__all__ = ["RadiusLowerBound", "RadiusBound", "SpeedBound",
           "PeriapsisRadius", "ApoapsisRadius", "FlightPathAngle",
           "CircularOrbit"]


def RadiusLowerBound(rmin, center=(0.0, 0.0, 0.0)):
    """|r - center|^2 >= rmin^2 as an inequality (<= 0 form)."""
    R = Args(3)
    c = np.asarray(center, float)
    return rmin ** 2 - (R - c).squared_norm()


def RadiusBound(rmin, rmax, center=(0.0, 0.0, 0.0)):
    """rmin <= |r - center| <= rmax: two inequality rows (<= 0 form)."""
    R = Args(3)
    c = np.asarray(center, float)
    rr = (R - c).squared_norm()
    return vf.stack([rmin ** 2 - rr, rr - rmax ** 2])


def SpeedBound(vmax):
    """|v| <= vmax (<= 0 form)."""
    V = Args(3)
    return V.squared_norm() - vmax ** 2


def PeriapsisRadius(mu, rp):
    """Periapsis radius of the osculating orbit equals rp: input [r, v].

    rp = a (1 - e) with a from the vis-viva energy and e from the
    eccentricity vector — all smooth expressions.
    """
    X = Args(6)
    r, v = X.head3(), X.segment3(3)
    rn = r.norm()
    h = vf.cross(r, v)
    evec = vf.cross(v, h) / mu - r.normalized()
    energy = 0.5 * v.squared_norm() - mu / rn
    a = -mu / (2.0 * energy)
    return a * (1.0 - evec.norm()) - rp


def ApoapsisRadius(mu, ra):
    """Apoapsis radius of the osculating orbit equals ra: input [r, v]."""
    X = Args(6)
    r, v = X.head3(), X.segment3(3)
    h = vf.cross(r, v)
    evec = vf.cross(v, h) / mu - r.normalized()
    energy = 0.5 * v.squared_norm() - mu / r.norm()
    a = -mu / (2.0 * energy)
    return a * (1.0 + evec.norm()) - ra


def FlightPathAngle(gamma):
    """sin(flight-path angle) equals sin(gamma): input [r, v]."""
    X = Args(6)
    r, v = X.head3(), X.segment3(3)
    return r.normalized().dot(v.normalized()) - np.sin(float(gamma))


def CircularOrbit(mu, radius):
    """Circular-orbit boundary conditions at `radius`: input [r, v] ->
    [|r| - radius, r.v, |v|^2 - mu/radius] (3 equality rows)."""
    X = Args(6)
    r, v = X.head3(), X.segment3(3)
    return vf.stack([r.norm() - radius, r.dot(v),
                     v.squared_norm() - mu / radius])
