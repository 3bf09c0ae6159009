"""Kepler propagation, Lambert solver, and element conversions.

Port of `asset_asrl_tpu/Astro/kepler.py` (reference
`src/Astro/KeplerPropagator.h`, `src/Astro/KeplerUtils.{h,cpp}`,
`src/Astro/LambertSolvers.{h,cpp}`).

* The universal-variable propagator runs the JAX package's Newton
  `while_loop` as 60 masked steps: a row steps while its last step was
  larger than 1e-13, so value and tangent freeze on the step where the
  JAX loop exits, and derivatives through it equal the JAX package's step
  for step.  The host call `propagate_kepler` stops once no row steps
  (checked every 8 steps; frozen rows do not change).
* Lambert runs its 40 Newton steps over all lanes at once, without an
  autograd graph; the slope of the time-of-flight map comes from
  `torch.func.jvp` with a unit tangent, since the map is elementwise.
* Every `jnp.clip` / `jnp.maximum` / `jnp.minimum` of the JAX package is
  `config.clip`, whose derivative at a tie is JAX's (1/2; `torch.clamp`
  gives 1).

The cores are branch-free tensor closures (usable inside expressions and
under `torch.func`).  Host entry points take and return numpy and compute
on `config.DEVICE`.  Classical elements are [a, e, i, RAAN, argp, mean
anomaly] (elliptic orbits); modified equinoctial [p, f, g, h, k, L].
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jvp

from .. import config
from ..config import clip
from ..VectorFunctions.function import VectorFunction

__all__ = ["KeplerPropagator", "propagate_kepler", "lambert_izzo",
           "lambert_izzo_batch", "lambert_izzo_multi",
           "cartesian_to_classic", "classic_to_cartesian",
           "cartesian_to_modified", "modified_to_cartesian",
           "true_to_mean_anomaly", "mean_to_true_anomaly",
           "CartesianToClassic", "ClassicToCartesian",
           "CartesianToModified", "ModifiedToCartesian",
           "ModifiedToClassic", "ClassicToModified"]


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


# ---------------------------------------------------------------- stumpff
def _stumpff_C(z):
    """C(z) = (1-cos(sqrt z))/z for z>0, (cosh(sqrt -z)-1)/(-z) for z<0."""
    sz = torch.sqrt(torch.abs(z) + 1e-300)
    pos = (1.0 - torch.cos(sz)) / (sz * sz)
    neg = (torch.cosh(sz) - 1.0) / (sz * sz)
    ser = 0.5 - z / 24.0 + z * z / 720.0
    return torch.where(torch.abs(z) < 1e-8, ser,
                       torch.where(z > 0, pos, neg))


def _stumpff_S(z):
    """S(z) = (sqrt z - sin(sqrt z))/z^1.5 etc."""
    sz = torch.sqrt(torch.abs(z) + 1e-300)
    pos = (sz - torch.sin(sz)) / sz ** 3
    neg = (torch.sinh(sz) - sz) / sz ** 3
    ser = 1.0 / 6.0 - z / 120.0 + z * z / 5040.0
    return torch.where(torch.abs(z) < 1e-8, ser,
                       torch.where(z > 0, pos, neg))


def _propagate_rv(rv, dt, mu, early=False):
    """Universal-variable Kepler propagation of [..., r (3), v (3)] by dt
    (shape [...]).  With `early`, stop once no row steps (host calls
    only: the check reads the device)."""
    r0 = rv[..., :3]
    v0 = rv[..., 3:6]
    r0n = torch.sqrt(_dot(r0, r0))
    vr0 = _dot(r0, v0) / r0n
    alpha = 2.0 / r0n - _dot(v0, v0) / mu     # 1/sma
    sqmu = math.sqrt(mu)

    chi = torch.where(torch.abs(alpha) > 1e-12,
                      sqmu * torch.abs(alpha) * dt,
                      torch.sign(dt) * torch.sqrt(r0n) * 0.1)
    err = torch.full_like(chi, float("inf"))
    for it in range(60):
        if early and it % 8 == 0 and not bool((err > 1e-13).any()):
            break
        active = err > 1e-13
        z = alpha * chi * chi
        C = _stumpff_C(z)
        S = _stumpff_S(z)
        F = (r0n * vr0 / sqmu * chi * chi * C
             + (1.0 - alpha * r0n) * chi ** 3 * S + r0n * chi
             - sqmu * dt)
        dF = (r0n * vr0 / sqmu * chi * (1.0 - z * S)
              + (1.0 - alpha * r0n) * chi * chi * C + r0n)
        # a frozen row's step is unused: keep it finite for reverse passes
        step = F / torch.where(active, dF, torch.ones_like(dF))
        chi = torch.where(active, chi - step, chi)
        err = torch.where(active, torch.abs(step), err)

    z = alpha * chi * chi
    C = _stumpff_C(z)
    S = _stumpff_S(z)
    f = 1.0 - chi * chi / r0n * C
    g = dt - chi ** 3 / sqmu * S
    r = f[..., None] * r0 + g[..., None] * v0
    rn = torch.sqrt(_dot(r, r))
    gdot = 1.0 - chi * chi / rn * C
    fdot = sqmu / (rn * r0n) * (z * S - 1.0) * chi
    v = fdot[..., None] * r0 + gdot[..., None] * v0
    return torch.cat([r, v], -1)


def propagate_kepler(rv, dt, mu=1.0):
    """Host-callable Kepler propagation; batch if rv is 2-D."""
    rv = np.asarray(rv, dtype=np.float64)
    with torch.no_grad():
        if rv.ndim == 2:
            dts = np.array(np.broadcast_to(np.asarray(dt, np.float64),
                                           rv.shape[0]))
            out = _propagate_rv(config.tensor(rv), config.tensor(dts), mu,
                                early=True)
        else:
            out = _propagate_rv(config.tensor(rv), config.tensor(float(dt)),
                                mu, early=True)
    return out.cpu().numpy()


def KeplerPropagator(mu=1.0):
    """Differentiable VectorFunction [r, v, dt] -> [r(dt), v(dt)]
    (reference `KeplerPropagator.h:37`)."""
    def impl(x):
        return _propagate_rv(x[:6], x[6], mu)
    return VectorFunction(impl, 7, 6, name="KeplerPropagator")


# ----------------------------------------------------------------- Lambert
def _lambert_core(r1, r2, tof, mu, longway, Nrevs, rightbranch):
    """Izzo-style Lambert (Lancaster-Blanchard x-parameter) over lanes
    r1, r2 (..., 3), tof (...): branch-free, a fixed 40-step Newton whose
    slope is the jvp of the elementwise time-of-flight map (reference
    `src/Astro/LambertSolvers.cpp:7-34`).  Returns (v1, v2)."""
    r1n = torch.sqrt(_dot(r1, r1))
    r2n = torch.sqrt(_dot(r2, r2))
    c = torch.sqrt(_dot(r2 - r1, r2 - r1))
    s = 0.5 * (r1n + r2n + c)
    lam2 = 1.0 - c / s
    lam0 = torch.sqrt(clip(lam2, 0.0))
    ihr = _cross(r1, r2)
    flip = ihr[..., 2] < 0
    lw = torch.logical_xor(torch.full_like(flip, bool(longway)), flip)
    lam = torch.where(lw, -lam0, lam0)
    T = torch.sqrt(2.0 * mu / s ** 3) * tof
    N = float(Nrevs)
    sgn = torch.sign(lam)

    def tof_of_x(x):
        # Lancaster-Blanchard time of flight, elliptic/hyperbolic branches
        xs = clip(x, -0.9999999, None)
        # elliptic branch (x < 1)
        xe = clip(xs, -1.0, 0.9999999)
        ae = 1.0 / (1.0 - xe * xe)
        alfa = 2.0 * torch.acos(xe)
        beta = 2.0 * torch.asin(clip(
            sgn * torch.sqrt(torch.abs(lam2 / ae)), -1.0, 1.0))
        te = (ae ** 1.5) * ((alfa - torch.sin(alfa))
                            - (beta - torch.sin(beta)) + 2.0 * math.pi * N)
        # hyperbolic branch (x > 1)
        xh = clip(xs, 1.0000001)
        ah = 1.0 / (1.0 - xh * xh)
        alfah = 2.0 * torch.acosh(xh)
        betah = 2.0 * torch.asinh(sgn * torch.sqrt(torch.abs(-lam2 / ah)))
        th = (-ah) ** 1.5 * ((betah - torch.sinh(betah))
                             - (alfah - torch.sinh(alfah)))
        return torch.where(xs < 1.0, te, th) / 2.0

    # initial guess (Izzo 2015): single-rev piecewise; multi-rev branch seed
    T0 = torch.acos(lam) + lam * torch.sqrt(clip(1 - lam2, 0.0))
    T1 = 2.0 / 3.0 * (1.0 - lam ** 3)
    x0_sr = torch.where(
        T >= T0, (T0 / T) ** (2.0 / 3.0) - 1.0,
        torch.where(T < T1,
                    5.0 / 2.0 * T1 / T * (T1 - T) / (1.0 - lam ** 5) + 1.0,
                    (T0 / T) ** (torch.log(T1 / T0) / math.log(2.0)) - 1.0))
    if Nrevs == 0:
        x = clip(x0_sr, -0.999999, 50.0)
        xmax = 1e3
    else:
        x = torch.full_like(T, 0.4 if rightbranch else -0.6)
        xmax = 0.999999
    one = torch.ones_like(x)
    with torch.no_grad():
        for _ in range(40):
            tx, df = jvp(tof_of_x, (x,), (one,))
            f = tx - T
            step = clip(f / torch.where(torch.abs(df) > 1e-300, df, one),
                         -0.5, 0.5)
            x = clip(x - step, -0.999999, xmax)

    gamma = torch.sqrt(mu * s / 2.0)
    rho = (r1n - r2n) / c
    sig = torch.sqrt(clip(1.0 - rho ** 2, 0.0))
    y = torch.sqrt(clip(1.0 - lam2 * (1.0 - x * x), 0.0))
    Vr1 = gamma * ((lam * y - x) - rho * (lam * y + x)) / r1n
    Vr2 = -gamma * ((lam * y - x) + rho * (lam * y + x)) / r2n
    Vt1 = gamma * sig * (y + lam * x) / r1n
    Vt2 = gamma * sig * (y + lam * x) / r2n

    ih = ihr / torch.sqrt(_dot(ihr, ihr))[..., None]
    ih = torch.where(lw[..., None], -ih, ih)
    u1 = r1 / r1n[..., None]
    u2 = r2 / r2n[..., None]
    v1 = Vr1[..., None] * u1 + Vt1[..., None] * _cross(ih, u1)
    v2 = Vr2[..., None] * u2 + Vt2[..., None] * _cross(ih, u2)
    return v1, v2


def _lambert(r1s, r2s, tofs, mu, longway, Nrevs, rightbranch):
    with torch.no_grad():
        v1, v2 = _lambert_core(
            config.tensor(np.asarray(r1s, np.float64)),
            config.tensor(np.asarray(r2s, np.float64)),
            config.tensor(np.asarray(tofs, np.float64)),
            mu, longway, Nrevs, rightbranch)
    return v1.cpu().numpy(), v2.cpu().numpy()


def lambert_izzo(r1, r2, tof, mu=1.0, longway=False, Nrevs=0,
                 rightbranch=False):
    """Izzo-style universal Lambert solver (single revolution default).

    Returns (v1, v2) as numpy arrays.  Multi-rev via Nrevs with left/right
    branch selection.  Reference: `src/Astro/LambertSolvers.cpp:7-34`."""
    V1, V2 = _lambert([r1], [r2], [float(tof)], mu, longway, Nrevs,
                      rightbranch)
    return V1[0], V2[0]


def lambert_izzo_batch(r1s, r2s, tofs, mu=1.0, longway=False, Nrevs=0,
                       rightbranch=False):
    """Batch Lambert: every lane's fixed-iteration solve at once on
    `config.DEVICE` (the reference threads its batch overloads,
    `LambertSolvers.cpp:21`).  Returns (V1 (n,3), V2 (n,3))."""
    return _lambert(r1s, r2s, tofs, mu, longway, Nrevs, rightbranch)


def lambert_izzo_multi(r1s, r2s, tofs, mu=1.0, longway=False, nthreads=None):
    """Batch Lambert returning a list of (v1, v2) pairs (reference
    list-of-pairs convention)."""
    V1, V2 = lambert_izzo_batch(r1s, r2s, tofs, mu, longway)
    return [(V1[i], V2[i]) for i in range(len(V1))]


# --------------------------------------------------------- element convs
# Branch-free cores, usable inside constraint expressions with exact AD
# (the reference binds every conversion as a VectorFunction,
# `src/Astro/KeplerUtils.cpp:13-59`); Kepler's equation is a fixed
# 25-step Newton, so AD through it gives the implicit derivative.

def _true_to_mean(ta, e):
    E = 2.0 * torch.atan2(torch.sqrt(clip(1 - e, 1e-300))
                          * torch.sin(ta / 2),
                          torch.sqrt(1 + e) * torch.cos(ta / 2))
    return E - e * torch.sin(E)


def _mean_to_true(M, e):
    E = M
    for _ in range(25):
        E = E - (E - e * torch.sin(E) - M) / (1 - e * torch.cos(E))
    return 2.0 * torch.atan2(torch.sqrt(1 + e) * torch.sin(E / 2),
                             torch.sqrt(clip(1 - e, 1e-300))
                             * torch.cos(E / 2))


def _cart_to_classic(rv, mu):
    r, v = rv[:3], rv[3:6]
    rn = torch.sqrt(r @ r)
    h = _cross(r, v)
    hn = torch.sqrt(h @ h)
    n = _cross(torch.tensor([0.0, 0.0, 1.0], dtype=rv.dtype,
                            device=rv.device), h)
    nn = torch.sqrt(n @ n)
    nns = clip(nn, 1e-300)
    evec = _cross(v, h) / mu - r / rn
    e = torch.sqrt(evec @ evec)
    es = clip(e, 1e-300)
    energy = v @ v / 2 - mu / rn
    a = -mu / (2 * energy)
    two_pi = 2 * math.pi
    i = torch.acos(clip(h[2] / hn, -1, 1))
    raan0 = torch.acos(clip(n[0] / nns, -1, 1))
    zero = torch.zeros_like(a)
    raan = torch.where(nn > 1e-14,
                       torch.where(n[1] < 0, two_pi - raan0, raan0), zero)
    argp0 = torch.acos(clip(n @ evec / (nns * es), -1, 1))
    argp = torch.where((nn > 1e-14) & (e > 1e-14),
                       torch.where(evec[2] < 0, two_pi - argp0, argp0), zero)
    ta0 = torch.acos(clip(evec @ r / (es * rn), -1, 1))
    ta_e = torch.where(r @ v < 0, two_pi - ta0, ta0)
    ta_c = torch.where(nn > 1e-14,
                       torch.acos(clip(n @ r / (nns * rn), -1, 1)),
                       torch.atan2(r[1], r[0]))
    ta = torch.where(e > 1e-14, ta_e, ta_c)
    M = torch.where(e < 1.0, _true_to_mean(ta, clip(e, None, 0.999999)), ta)
    return torch.stack([a, e, i, raan, argp, M])


def _classic_to_cart(oe, mu):
    a, e, i, raan, argp, M = (oe[0], oe[1], oe[2], oe[3], oe[4], oe[5])
    ta = torch.where(e < 1.0, _mean_to_true(M, clip(e, None, 0.999999)), M)
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


def _cart_to_modified(rv, mu):
    oe = _cart_to_classic(rv, mu)
    a, e, i, raan, argp, M = (oe[0], oe[1], oe[2], oe[3], oe[4], oe[5])
    ta = torch.where(e < 1.0, _mean_to_true(M, clip(e, None, 0.999999)), M)
    p = a * (1 - e * e)
    f = e * torch.cos(argp + raan)
    g = e * torch.sin(argp + raan)
    h = torch.tan(i / 2) * torch.cos(raan)
    k = torch.tan(i / 2) * torch.sin(raan)
    L = raan + argp + ta
    return torch.stack([p, f, g, h, k, L])


def _modified_to_cart(mee, mu):
    p, f, g, h, k, L = (mee[0], mee[1], mee[2], mee[3], mee[4], mee[5])
    s2 = 1 + h * h + k * k
    a2 = h * h - k * k
    cL, sL = torch.cos(L), torch.sin(L)
    w = 1 + f * cL + g * sL
    rn = p / w
    r = rn / s2 * torch.stack([
        cL + a2 * cL + 2 * h * k * sL,
        sL - a2 * sL + 2 * h * k * cL,
        2 * (h * sL - k * cL)])
    sqmu_p = torch.sqrt(mu / p)
    v = sqmu_p / s2 * torch.stack([
        -(sL + a2 * sL - 2 * h * k * cL + g - 2 * f * h * k + a2 * g),
        -(-cL + a2 * cL + 2 * h * k * sL - f + 2 * g * h * k + a2 * f),
        2 * (h * cL + k * sL + f * h + g * k)])
    return torch.cat([r, v])


def _vec(v, n):
    return config.tensor(np.array(v, np.float64).ravel()[:n])


def _host(core, v, mu):
    with torch.no_grad():
        return core(_vec(v, 6), mu).cpu().numpy()


def true_to_mean_anomaly(ta, e):
    return float(_true_to_mean(config.tensor(float(ta)),
                               config.tensor(float(e))))


def mean_to_true_anomaly(M, e, tol=1e-13):
    return float(_mean_to_true(config.tensor(float(M)),
                               config.tensor(float(e))))


def cartesian_to_classic(rv, mu=1.0):
    """[r, v] -> [a, e, i, RAAN, argp, mean anomaly] (elliptic), matching
    the reference convention (`KeplerUtils.h:20`)."""
    return _host(_cart_to_classic, rv, mu)


def classic_to_cartesian(oe, mu=1.0):
    """[a, e, i, RAAN, argp, mean anomaly] -> [r, v] (reference
    `KeplerUtils.h:20`)."""
    return _host(_classic_to_cart, oe, mu)


def cartesian_to_modified(rv, mu=1.0):
    """[r, v] -> modified equinoctial [p, f, g, h, k, L]."""
    return _host(_cart_to_modified, rv, mu)


def modified_to_cartesian(mee, mu=1.0):
    """[p, f, g, h, k, L] -> [r, v]."""
    return _host(_modified_to_cart, mee, mu)


# VectorFunction wrappers: differentiable element conversions usable inside
# boundary constraints (reference `KeplerUtils.cpp:13-59`).
def CartesianToClassic(mu=1.0):
    return VectorFunction(lambda x: _cart_to_classic(x, mu), 6, 6,
                          name="CartesianToClassic")


def ClassicToCartesian(mu=1.0):
    return VectorFunction(lambda x: _classic_to_cart(x, mu), 6, 6,
                          name="ClassicToCartesian")


def CartesianToModified(mu=1.0):
    return VectorFunction(lambda x: _cart_to_modified(x, mu), 6, 6,
                          name="CartesianToModified")


def ModifiedToCartesian(mu=1.0):
    return VectorFunction(lambda x: _modified_to_cart(x, mu), 6, 6,
                          name="ModifiedToCartesian")


def ModifiedToClassic(mu=1.0):
    return VectorFunction(
        lambda x: _cart_to_classic(_modified_to_cart(x, mu), mu), 6, 6,
        name="ModifiedToClassic")


def ClassicToModified(mu=1.0):
    return VectorFunction(
        lambda x: _cart_to_modified(_classic_to_cart(x, mu), mu), 6, 6,
        name="ClassicToModified")
