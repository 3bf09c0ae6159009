"""Plain reference of cartpole-lgl5 (`configs/cartpole-lgl5.py`).

The cart-pole of Kelly (2017), section 6 and appendix E, in its explicit
form:

    xdd  = (l m2 sin(th) thd^2 + u + m2 g cos(th) sin(th))
           / (m1 + m2 (1 - cos(th)^2))
    thdd = -(l m2 cos(th) sin(th) thd^2 + u cos(th) + (m1 + m2) g sin(th))
           / (l m1 + l m2 (1 - cos(th)^2))

transcribed by Hermite-LGL collocation (`collocation.Phase`, 3 cardinal
states a segment for LGL5).  `problem(cfg, X)` returns the objective and
the constraints of the solver vectors X (B, n) in the order the
transcription states them: equalities = the defects, the linear control
spline of the inner cardinal, the 5 start values (states and t0), the 5
goal values; inequalities (c <= 0) = the force bound, then the cart
bound, as (lo - v, v - hi) at every node.  Plain PyTorch only.
"""

import math

import torch

from portbench.reference.collocation import Phase

CARDINALS = {"LGL3": 2, "LGL5": 3, "LGL7": 4}


def layout(cfg):
    return Phase(CARDINALS[cfg["transcription"]], cfg["nsegs"], 4, 1)


def rhs(cfg):
    m1, m2, l, g = cfg["m1"], cfg["m2"], cfg["l"], cfg["g"]

    def f(x, u, t):
        th, xd, thd = x[..., 1], x[..., 2], x[..., 3]
        s, c = torch.sin(th), torch.cos(th)
        F = u[..., 0]
        xdd = (l * m2 * s * thd ** 2 + F + m2 * g * c * s) \
            / (m1 + m2 * (1.0 - c ** 2))
        thdd = -(l * m2 * c * s * thd ** 2 + F * c + (m1 + m2) * g * s) \
            / (l * m1 + l * m2 * (1.0 - c ** 2))
        return torch.stack([xd, thd, xdd, thdd], -1)
    return f


def problem(cfg, X):
    """(objective (B,), equalities (B, mE), inequalities (B, mI))."""
    ph = layout(cfg)
    x, u, t0, tf = ph.split(X)
    goal = torch.tensor([cfg["d"], math.pi, 0.0, 0.0, cfg["T"]],
                        dtype=X.dtype, device=X.device)
    first = torch.cat([x[:, 0], t0[:, None]], 1)
    last = torch.cat([x[:, -1], tf[:, None]], 1) - goal
    eq = torch.cat([ph.defects(X, rhs(cfg)), ph.linear_spline(X), first,
                    last], 1)

    def box(v, hi):
        return torch.stack([-hi - v, v - hi], -1).reshape(X.shape[0], -1)
    iq = torch.cat([box(u[..., 0], cfg["u_max"]),
                    box(x[..., 0], cfg["x_max"])], 1)
    obj = ph.integral(X, lambda xs, us, ts: us[..., 0] ** 2).sum(1)
    return obj, eq, iq
