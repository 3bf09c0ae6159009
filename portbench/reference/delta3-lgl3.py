"""Plain reference of delta3-lgl3 (`configs/delta3-lgl3.py`).

Betts' Delta III launch (Practical Methods for Optimal Control, 2nd ed.,
section 6.15), in the canonical units of ASSET's example (length Lstar,
time Tstar, mass Mstar).  The state is x = [r (3), v (3), m], the control
u (3); each of the four phases burns with a constant thrust T and mass
flow mdot:

    r' = v
    v' = -mu r / |r|^3 + (T u / |u| + D) / m
    m' = -mdot
    D  = -1/2 CD S rho0 exp(-(|r| - Re) / H) |v_rel| v_rel,
    v_rel = v + r x [0, 0, We]   (the air turns with the Earth)

Phase 1 burns six solid boosters with the first stage, phase 2 the other
three with it, phase 3 the first stage alone, phase 4 the second stage;
the phases end at 75.2, 150.4 and 261 s, the last by 961 s, and each
starts with the mass it had less the dry mass it dropped.

Each phase is transcribed by Hermite-LGL3 collocation (`collocation.
Phase`, 2 cardinal states a segment, `nsegs` segments).  `problem(cfg, X)`
returns the objective and the constraints of the solver vectors X (B, n),
the four phases' vectors one after another, in the order and sign the
program states them:

    equalities, phase by phase: the defects; phase 1: the launch state,
    mass and time 0, then its end time; phases 2 and 3: the start mass,
    then the end time; phase 4: the start mass, then the five elements
    (a, e, i, RAAN, argument of perigee) at burnout minus their targets;
    then the links: for each phase but the last, its end minus the next
    phase's start in r, v, t and u;

    inequalities (c <= 0), phase by phase: at every node lo - |u| and
    |u| - hi, then at every node r_min - |r| (r_min = Re, 0.999999 Re in
    phase 1); phase 4: then its end time less its bound;

    objective: -m at burnout.

Departures from the published description: none in the problem; the
control's norm bound and the radius bound are stated on every node, as
the program does; the HighestOrderSpline control mode adds no rows at
LGL3 (a segment's control is linear between its two cardinals, so there
is no derivative of higher order to join).  Plain PyTorch only.
"""

import math

import torch

from portbench.reference.collocation import Phase

NX, NU = 7, 3
# the link's entries of a boundary [r, v, m, t, u]: all but the mass
LINKED = [0, 1, 2, 3, 4, 5, 7, 8, 9, 10]


def canonical(cfg):
    """The problem's numbers in canonical units: a dict."""
    L, T, M = cfg["Lstar"], cfg["Tstar"], cfg["Mstar"]
    acc = L / T ** 2
    force = acc * M
    g = cfg["g0"] / acc
    solid, first, second = (
        (cfg[f"T_{s}"] / force, cfg[f"Isp_{s}"] / T, cfg[f"t_{s}"] / T,
         cfg[f"m_{s}"] / M, cfg[f"mp_{s}"] / M)
        for s in ("solid", "first", "second"))
    TS, IS, tS, MS, PS = solid
    T1, I1, t1, M1, P1 = first
    T2, I2, t2, M2, P2 = second
    # mass at each phase's start: lift-off, then less the propellant each
    # phase burns and the dry mass dropped between phases
    m0 = [9 * MS + M1 + M2 + cfg["m_payload"] / M]
    m0.append(m0[0] - 6 * PS - (tS / t1) * P1 - 6 * (MS - PS))
    m0.append(m0[1] - 3 * PS - (tS / t1) * P1 - 3 * (MS - PS))
    m0.append(m0[2] - (1 - 2 * tS / t1) * P1 - (M1 - P1))
    return dict(
        mu=cfg["mu"] / (L ** 3 / T ** 2), Re=cfg["Re"] / L,
        We=cfg["We"] * T, rho0=cfg["rho0"] / (M / L ** 3),
        H=cfg["h_scale"] / L, drag=0.5 * cfg["CD"] * cfg["S"] / L ** 2,
        thrust=[6 * TS + T1, 3 * TS + T1, T1, T2],
        mdot=[(6 * TS / IS + T1 / I1) / g, (3 * TS / IS + T1 / I1) / g,
              T1 / (g * I1), T2 / (g * I2)],
        t_end=[tS, 2 * tS, t1, t1 + t2], m0=m0,
        elements=[cfg["a_target"] / L, cfg["e_target"],
                  math.radians(cfg["i_target_deg"]),
                  math.radians(cfg["raan_target_deg"]),
                  math.radians(cfg["argp_target_deg"])],
        v_lift=1e-5 / (L / T))


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def rhs(c, k):
    """The dynamics of phase k."""
    T, mdot = c["thrust"][k], c["mdot"][k]

    def f(x, u, t):
        r, v, m = x[..., 0:3], x[..., 3:6], x[..., 6:7]
        rn = _norm(r)[..., None]
        w = torch.zeros_like(r)
        w[..., 2] = c["We"]
        vrel = v + _cross(r, w)
        rho = c["rho0"] * torch.exp(-(rn - c["Re"]) / c["H"])
        D = -c["drag"] * rho * vrel * _norm(vrel)[..., None]
        acc = -c["mu"] * r / rn ** 3 + (T * u / _norm(u)[..., None] + D) / m
        return torch.cat([v, acc, torch.full_like(m, -mdot)], -1)
    return f


def elements(c, r, v):
    """(B, 5) a, e, i, RAAN and argument of perigee of the states r, v."""
    mu = c["mu"]
    rn, vn = _norm(r), _norm(v)
    h = _cross(r, v)
    node = torch.stack([-h[:, 1], h[:, 0], torch.zeros_like(h[:, 0])], -1)
    a = -0.5 * mu / (0.5 * vn ** 2 - mu / rn)
    ecc = _cross(v, h) / mu - r / rn[:, None]
    e = _norm(ecc)
    i = torch.acos(h[:, 2] / _norm(h))
    nhat = node / _norm(node)[:, None]
    raan = torch.acos(nhat[:, 0])
    raan = torch.where(node[:, 1] > 0, raan, 2 * math.pi - raan)
    argp = torch.acos((nhat * ecc / e[:, None]).sum(-1))
    argp = torch.where(ecc[:, 2] > 0, argp, 2 * math.pi - argp)
    return torch.stack([a, e, i, raan, argp], -1)


def launch(c, cfg, like):
    """[r, v, m, t] at lift-off: the launch site on the equator's plane
    turned by the latitude, moving with the surface."""
    lat = c["elements"][2]
    r = c["Re"] * torch.tensor([math.cos(lat), 0.0, math.sin(lat)],
                               dtype=like.dtype, device=like.device)
    w = torch.zeros_like(r)
    w[2] = c["We"]
    v = -_cross(r, w)
    v[0] = v[0] + c["v_lift"]
    return torch.cat([r, v, r.new_tensor([c["m0"][0], 0.0])])


def problem(cfg, X):
    """(objective (B,), equalities (B, mE), inequalities (B, mI))."""
    c = canonical(cfg)
    ph = Phase(2, cfg["nsegs"], NX, NU)
    B = X.shape[0]
    lo, hi = cfg["u_norm_bounds"]
    eqs, iqs, ends = [], [], []
    for k in range(4):
        Xk = X[:, k * ph.n:(k + 1) * ph.n]
        x, u, t0, tf = ph.split(Xk)
        eqs.append(ph.defects(Xk, rhs(c, k)))
        if k == 0:
            eqs.append(torch.cat([x[:, 0], t0[:, None]], 1)
                       - launch(c, cfg, X))
        else:
            eqs.append(x[:, 0, 6:7] - c["m0"][k])
        if k < 3:
            eqs.append(tf[:, None] - c["t_end"][k])
        else:
            eqs.append(elements(c, x[:, -1, 0:3], x[:, -1, 3:6])
                       - X.new_tensor(c["elements"]))
        un = _norm(u)
        iqs.append(torch.stack([lo - un, un - hi], -1).reshape(B, -1))
        r_min = c["Re"] * (cfg["r_min_first_phase"] if k == 0 else 1.0)
        iqs.append(r_min - _norm(x[..., 0:3]))
        if k == 3:
            iqs.append(tf[:, None] - c["t_end"][3])
        # [r, v, m, t, u] at the phase's start and end
        ends.append([torch.cat([x[:, j], t[:, None], u[:, j]], 1)
                     for j, t in ((0, t0), (-1, tf))])
    for k in range(3):
        eqs.append(ends[k][1][:, LINKED] - ends[k + 1][0][:, LINKED])
    obj = -X[:, 3 * ph.n + (ph.N - 1) * ph.m + 6]
    return obj, torch.cat(eqs, 1), torch.cat(iqs, 1)
