"""The comparison that decides `correct`.

Every answer of the window (a solver vector x with its multipliers, the
objective the program reports and its convergence flag) is judged by the
configuration's plain reference, which recomputes the objective and the
constraints from x alone (`reference/<config>.py`, `problem(cfg, X)`).
Six numbers an answer, each the worst over the answers judged:

    feas      the largest constraint violation: |c_E|, and c_I above 0
    stat      the largest entry of the gradient of the Lagrangian
              sigma f + lamE . c_E + lamI . c_I, with the program's
              multipliers (first-order optimality)
    dual      the most negative inequality multiplier, as a positive
              number (dual feasibility: lamI >= 0 for c_I <= 0)
    compl     the largest |lamI c_I| (complementarity)
    obj_gap   |f(x) - the reported objective| / max(|f(x)|, 1)
    flag      the largest convergence flag (0: converged); the traffic
              is chosen so that every answer converges

The control (`control`) is the reference in the program's place in the
precision below float64: every answer rounded to float32, with the
objective the reference computes in float32.
"""

import numpy as np
import torch

NUMBERS = ("feas", "stat", "dual", "compl", "obj_gap", "flag")


def _readings(ref, cfg, X, LE, LI, OBJ, sigma):
    X = X.detach().clone().requires_grad_(True)
    obj, eq, iq = ref.problem(cfg, X)
    lag = sigma * obj + (LE * eq).sum(1) + (LI * iq).sum(1)
    grad, = torch.autograd.grad(lag.sum(), X)
    with torch.no_grad():
        feas = torch.cat([eq.abs(), iq.clamp(min=0.0)], 1).amax(1)
        gap = (obj - OBJ).abs() / obj.abs().clamp(min=1.0)
        dual = (-LI).clamp(min=0.0).amax(1)
        compl = (LI * iq).abs().amax(1)
    return dict(feas=feas, stat=grad.abs().amax(1), dual=dual, compl=compl,
                obj_gap=gap.detach())


def readings(ref, cfg, answers, device, block=64):
    """Per-answer numbers, each a float64 numpy array of len(answers),
    computed in float64 on `device` in blocks of `block` answers."""
    out = {k: [] for k in NUMBERS if k != "flag"}
    n = len(answers["obj"])
    for lo in range(0, n, block):
        part = {k: torch.as_tensor(np.asarray(answers[k][lo:lo + block]),
                                   dtype=torch.float64, device=device)
                for k in ("x", "lamE", "lamI", "obj")}
        r = _readings(ref, cfg, part["x"], part["lamE"], part["lamI"],
                      part["obj"], float(answers["sigma"]))
        for k in out:
            out[k].append(r[k].cpu().numpy())
    out = {k: np.concatenate(v) if v else np.zeros(0)
           for k, v in out.items()}
    out["flag"] = np.asarray(answers["flag"], np.float64).ravel()
    return out


def control(ref, cfg, answers, device, block=64):
    """The control's answers: each answer rounded to float32, its
    objective the reference's in float32, its flag the program's."""
    def f32(a):
        return np.asarray(a, np.float32).astype(np.float64)
    x = f32(answers["x"])
    objs = []
    for lo in range(0, len(x), block):
        X = torch.as_tensor(x[lo:lo + block], dtype=torch.float32,
                            device=device)
        objs.append(ref.problem(cfg, X)[0].double().cpu().numpy())
    return dict(x=x, lamE=f32(answers["lamE"]), lamI=f32(answers["lamI"]),
                obj=np.concatenate(objs), flag=answers["flag"],
                sigma=answers["sigma"])


def checks(per_answer, limits):
    """{name: {"value": worst, "limit": limit}} in NUMBERS order, and
    whether every value is within its limit."""
    out, ok = {}, True
    for k in NUMBERS:
        v = per_answer[k]
        worst = float(v.max()) if v.size and np.isfinite(v).all() \
            else float("inf")
        out[k] = {"value": worst, "limit": float(limits[k])}
        ok = ok and worst <= limits[k]
    return out, ok
