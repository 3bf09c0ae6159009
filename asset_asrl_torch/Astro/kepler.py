"""Classical orbital elements <-> Cartesian state.

Port of the element conversions of `asset_asrl_tpu/Astro/kepler.py`.  The
cores are branch-free torch closures (usable inside expressions and under
`torch.func`); Kepler's equation is solved by a fixed 25-step Newton
iteration, so differentiating through it gives the implicit derivative.
Elements are [a, e, i, RAAN, argp, mean anomaly] (elliptic orbits).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config

__all__ = ["cartesian_to_classic", "classic_to_cartesian",
           "true_to_mean_anomaly", "mean_to_true_anomaly"]


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _true_to_mean(ta, e):
    E = 2.0 * torch.atan2(torch.sqrt(torch.clamp(1 - e, min=1e-300))
                          * torch.sin(ta / 2),
                          torch.sqrt(1 + e) * torch.cos(ta / 2))
    return E - e * torch.sin(E)


def _mean_to_true(M, e):
    E = M
    for _ in range(25):
        E = E - (E - e * torch.sin(E) - M) / (1 - e * torch.cos(E))
    return 2.0 * torch.atan2(torch.sqrt(1 + e) * torch.sin(E / 2),
                             torch.sqrt(torch.clamp(1 - e, min=1e-300))
                             * torch.cos(E / 2))


def _cart_to_classic(rv, mu):
    r, v = rv[:3], rv[3:6]
    rn = torch.sqrt(r @ r)
    h = _cross(r, v)
    hn = torch.sqrt(h @ h)
    n = _cross(torch.tensor([0.0, 0.0, 1.0], dtype=rv.dtype,
                            device=rv.device), h)
    nn = torch.sqrt(n @ n)
    nns = torch.clamp(nn, min=1e-300)
    evec = _cross(v, h) / mu - r / rn
    e = torch.sqrt(evec @ evec)
    es = torch.clamp(e, min=1e-300)
    energy = v @ v / 2 - mu / rn
    a = -mu / (2 * energy)
    two_pi = 2 * math.pi
    i = torch.acos(torch.clamp(h[2] / hn, -1, 1))
    raan0 = torch.acos(torch.clamp(n[0] / nns, -1, 1))
    zero = torch.zeros_like(a)
    raan = torch.where(nn > 1e-14,
                       torch.where(n[1] < 0, two_pi - raan0, raan0), zero)
    argp0 = torch.acos(torch.clamp(n @ evec / (nns * es), -1, 1))
    argp = torch.where((nn > 1e-14) & (e > 1e-14),
                       torch.where(evec[2] < 0, two_pi - argp0, argp0), zero)
    ta0 = torch.acos(torch.clamp(evec @ r / (es * rn), -1, 1))
    ta_e = torch.where(r @ v < 0, two_pi - ta0, ta0)
    ta_c = torch.where(nn > 1e-14,
                       torch.acos(torch.clamp(n @ r / (nns * rn), -1, 1)),
                       torch.atan2(r[1], r[0]))
    ta = torch.where(e > 1e-14, ta_e, ta_c)
    M = torch.where(e < 1.0,
                    _true_to_mean(ta, torch.clamp(e, max=0.999999)), ta)
    return torch.stack([a, e, i, raan, argp, M])


def _classic_to_cart(oe, mu):
    a, e, i, raan, argp, M = (oe[0], oe[1], oe[2], oe[3], oe[4], oe[5])
    ta = torch.where(e < 1.0,
                     _mean_to_true(M, torch.clamp(e, max=0.999999)), M)
    p = a * (1 - e * e)
    rn = p / (1 + e * torch.cos(ta))
    r_pf = rn * torch.stack([torch.cos(ta), torch.sin(ta), 0.0 * ta])
    v_pf = torch.sqrt(mu / p) * torch.stack([-torch.sin(ta),
                                             e + torch.cos(ta), 0.0 * ta])
    cO, sO = torch.cos(raan), torch.sin(raan)
    co, so = torch.cos(argp), torch.sin(argp)
    ci, si = torch.cos(i), torch.sin(i)
    R = torch.stack([
        torch.stack([cO * co - sO * so * ci, -cO * so - sO * co * ci,
                     sO * si]),
        torch.stack([sO * co + cO * so * ci, -sO * so + cO * co * ci,
                     -cO * si]),
        torch.stack([so * si, co * si, ci])])
    return torch.cat([R @ r_pf, R @ v_pf])


def _vec(v, n):
    return config.tensor(np.array(v, np.float64).ravel()[:n])


def true_to_mean_anomaly(ta, e):
    return float(_true_to_mean(config.tensor(float(ta)),
                               config.tensor(float(e))))


def mean_to_true_anomaly(M, e):
    return float(_mean_to_true(config.tensor(float(M)),
                               config.tensor(float(e))))


def cartesian_to_classic(rv, mu=1.0):
    """[r, v] -> [a, e, i, RAAN, argp, mean anomaly] (numpy)."""
    return _cart_to_classic(_vec(rv, 6), mu).cpu().numpy()


def classic_to_cartesian(oe, mu=1.0):
    """[a, e, i, RAAN, argp, mean anomaly] -> [r, v] (numpy)."""
    return _classic_to_cart(_vec(oe, 6), mu).cpu().numpy()
