"""LGLInterpTable / InterpFunction parity: the port's tables against the JAX
package's on the same seeded rows and on solved LGL3/5/7 phases, all to
1e-12 (relative to the largest entry)."""

import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_torch.interop import load_phase_state, phase_state_to_numpy
from chip_smoke import build_brachistochrone, cartpole_ode

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

PACKAGES = (jast, tast)
TOL = 1e-12


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), \
        np.abs(a - b).max()


def seeded_rows(n=14, seed=0):
    """Rows [x (4), t, u (1)] of a smooth seeded curve on an uneven time
    grid, given out of order."""
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0.0, 2.0, n))
    a = rng.normal(size=(5, 3))
    cols = [a[i, 0] * np.sin(a[i, 1] * ts) + a[i, 2] * ts for i in range(5)]
    rows = np.stack(cols[:4] + [ts] + cols[4:], axis=1)
    return rows[rng.permutation(n)]


def tables(form):
    rows = seeded_rows()
    out = []
    for ast in PACKAGES:
        T = ast.OptimalControl.LGLInterpTable
        if form == "ode":
            out.append(T(cartpole_ode(ast).vf(), 4, 1, rows))
        elif form == "time_last":
            out.append(T(np.delete(np.hstack([rows, rows[:, 4:5]]), 4,
                                   axis=1)))
        else:
            out.append(T(4, rows, len(rows)))
    return out


QUERY = [0.0, 0.13, 0.77, 1.0, 1.61, 2.0, -1.0, 3.0]   # two outside the range


@pytest.mark.parametrize("form", ["ode", "time_last", "raw"])
def test_constructors_and_queries(form):
    tj, tt = tables(form)
    assert tt.tcol == tj.tcol
    for a in ("ts", "vals", "tangents", "rows"):
        close(getattr(tt, a), getattr(tj, a))
    assert (tt.T0, tt.TF, tt.TotalT) == (tj.T0, tj.TF, tj.TotalT)
    for t in QUERY:
        close(tt.Interpolate(t), tj.Interpolate(t))
        close(tt(t), tj(t))
    for t in QUERY[:6]:
        close(tt.InterpolateDeriv(t), tj.InterpolateDeriv(t))
    close(tt.eval_batch(QUERY), tj.eval_batch(QUERY))
    close(np.stack(tt.InterpRange(7, 0.2, 1.9)),
          np.stack(tj.InterpRange(7, 0.2, 1.9)))
    close(np.stack(tt.InterpWholeRange(5)), np.stack(tj.InterpWholeRange(5)))
    tt.makePeriodic()


@pytest.fixture(scope="module", params=["LGL3", "LGL5", "LGL7"])
def solved(request):
    """A Brachistochrone solved by the port, and a JAX phase holding the
    same iterate."""
    pt = build_brachistochrone(tast, request.param, 8)
    pt.optimizer.set_PrintLevel(2)
    assert pt.optimize() == 0
    pj = build_brachistochrone(jast, request.param, 8)
    load_phase_state(pj, phase_state_to_numpy(pt))
    return pj, pt


def test_from_phase(solved):
    pj, pt = solved
    tj, tt = pj.returnTrajTable(), pt.returnTrajTable()
    for a in ("_seg_t", "_seg_h", "_coef", "_ucoef"):
        close(getattr(tt, a), getattr(tj, a))
    ts = np.linspace(pt.t0 - 0.1, pt.tf + 0.1, 41)
    close(tt.eval_batch(ts), tj.eval_batch(ts))
    for t in ts[::5]:
        close(tt.Interpolate(t), tj.Interpolate(t))
    for t in ts[3:-3:5]:
        close(tt.InterpolateDeriv(t), tj.InterpolateDeriv(t))
    # the traced lookup and the numpy batch evaluation are one function
    close(np.stack([np.delete(tt.Interpolate(t), tt.tcol) for t in ts]),
          tt.eval_batch(ts))
    # nodes are reproduced
    node_t = pt._traj[:, pt.XV]
    close(tt.eval_batch(node_t), np.delete(pt._traj, pt.XV, axis=1), 1e-11)


def test_interp_traced_under_vmap_and_jacfwd(solved):
    pj, pt = solved
    tj, tt = pj.returnTrajTable(), pt.returnTrajTable()
    ts = np.linspace(pt.t0, pt.tf, 9)[1:-1]
    tq = tast.config.tensor(ts)
    vals = vmap(tt.interp_traced)(tq).numpy()
    ders = vmap(jacfwd(tt.interp_traced))(tq).numpy()
    close(vals, tj.eval_batch(ts))
    close(ders, np.stack([tj.InterpolateDeriv(t) for t in ts]))


def test_from_phase_raises_on_backward_phase(solved):
    pj, pt = solved
    state = phase_state_to_numpy(pt)
    back = build_brachistochrone(tast, pt.TranscriptionMode, 8)
    load_phase_state(back, state)
    back.t0, back.tf = back.tf, back.t0
    with pytest.raises(ValueError, match="forward"):
        back.returnTrajTable()


@pytest.mark.parametrize("n", [1, 3, 6, None])
def test_interp_function(n):
    rows = np.delete(np.hstack([seeded_rows(seed=3), np.zeros((14, 3))]), 4,
                     axis=1)
    rows = np.hstack([rows, seeded_rows(seed=3)[:, 4:5]])   # 8 values + t
    fs = []
    for ast in PACKAGES:
        oc = ast.OptimalControl
        tab = oc.LGLInterpTable(rows)
        fs.append(oc.InterpFunction(tab, [5, 0, 2]) if n is None
                  else getattr(oc, f"InterpFunction_{n}")(tab))
    fj, ft = fs
    assert (ft.IRows(), ft.ORows()) == (fj.IRows(), fj.ORows())
    for t in (0.1, 0.9, 1.7):
        close(ft.compute([t]), fj.compute([t]))
        close(ft.jacobian([t]), fj.jacobian([t]))
    # inside an expression
    gj, gt = (ast.VectorFunctions.sin(f) * 2.0 for ast, f in
              zip(PACKAGES, fs))
    close(gt.compute([0.5]), gj.compute([0.5]))
