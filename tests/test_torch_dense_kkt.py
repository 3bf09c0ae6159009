"""The dense KKT backend (`kkt_dense.DenseKKT`, eigendecomposition) against
the JAX package's `DenseKKT` on one iterate of the Brachistochrone
(LGL3, 8 segments): the dense KKT data (`NonLinearProgram.eval_kkt`) to
1e-12, the same inertia, the same solve to 1e-10; a dense-backend solve
against the JAX host loop; and the fallback rule: only the structure
`ValueError` of `BlockKKT.__init__` sends a problem to the dense
backend."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_tpu.Solvers.kkt_dense import DenseKKT as JDenseKKT
from asset_asrl_torch.Solvers import kkt_block
from asset_asrl_torch.Solvers.kkt_dense import DenseKKT
from chip_smoke import build_brachistochrone

torch.set_num_threads(2)


def close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= tol * max(
        1.0, np.abs(a).max(initial=0.0))


def dense_phase(ast):
    p = build_brachistochrone(ast, "LGL3", 8)
    p.optimizer.set_PrintLevel(2)
    p.optimizer.UseFused = False
    p.setKKTBackend("dense")
    return p


@pytest.fixture(scope="module")
def iterate():
    pj, pt = dense_phase(jast), dense_phase(tast)
    pj.transcribe()
    pt.transcribe()
    assert pj.optimizer.kkt is None and pt.optimizer.kkt is None
    nlp = pj._nlp
    rng = np.random.default_rng(21)
    x = pj.makeSolverInput() + 0.01 * rng.normal(size=nlp.numPrimal)
    lamE = rng.normal(size=nlp.numEq)
    lamI = rng.uniform(0.1, 1.0, size=nlp.numIq)
    sig = rng.uniform(0.5, 2.0, size=nlp.numIq)
    return pj, pt, x, lamE, lamI, sig


def test_eval_kkt_matches_jax(iterate):
    pj, pt, x, lamE, lamI, _ = iterate
    a = pj._nlp.eval_kkt(jnp.asarray(x), jnp.asarray(lamE),
                         jnp.asarray(lamI), 1.0)
    b = pt._nlp.eval_kkt(torch.tensor(x), torch.tensor(lamE),
                         torch.tensor(lamI), 1.0)
    for u, v in zip(a, b):
        close(u, v, 1e-12)


@pytest.mark.parametrize("delta", [0.0, 1e-4])
def test_factor_solve_matches_jax(iterate, delta):
    pj, pt, x, lamE, lamI, sig = iterate
    kj, kt = JDenseKKT(pj._nlp), DenseKKT(pt._nlp)
    xj, lEj, lIj = (jnp.asarray(a) for a in (x, lamE, lamI))
    xt, lEt, lIt = (torch.tensor(a) for a in (x, lamE, lamI))
    rj, rt = kj.eval_resid(xj, lEj, lIj, 1.0), kt.eval_resid(xt, lEt, lIt,
                                                             1.0)
    for u, v in zip(rj, rt):
        close(u, v, 1e-12)
    fj, nj = kj.factor(xj, lEj, lIj, 1.0, jnp.asarray(sig), delta, 1e-10)
    ft, nt = kt.factor(xt, lEt, lIt, 1.0, torch.tensor(sig), delta, 1e-10)
    assert nj == nt
    rng = np.random.default_rng(8)
    rx = rng.normal(size=x.shape[0])
    rE = rng.normal(size=lamE.shape[0])
    for u, v in zip(kj.solve(fj, jnp.asarray(rx), jnp.asarray(rE)),
                    kt.solve(ft, torch.tensor(rx), torch.tensor(rE))):
        close(u, v, 1e-10)
    v = rng.normal(size=lamI.shape[0])
    close(kj.iq_rmatvec(fj, jnp.asarray(v)), kt.iq_rmatvec(ft,
                                                           torch.tensor(v)),
          1e-12)
    close(kj.iq_matvec(fj, jnp.asarray(rx)), kt.iq_matvec(ft,
                                                          torch.tensor(rx)),
          1e-12)


def test_dense_backend_solve_matches_jax():
    res = []
    for ast in (jast, tast):
        p = dense_phase(ast)
        flag = p.optimize()
        res.append((flag, p.optimizer.LastIterNum, p.optimizer.LastObjVal))
    assert res[0][:2] == res[1][:2] and res[0][0] == 0
    assert abs(res[0][2] - res[1][2]) <= 1e-9 * abs(res[0][2])


def test_fallback_only_on_structure_error(monkeypatch):
    """A structure ValueError from BlockKKT.__init__ sends the problem to
    the dense backend; any other error propagates."""
    def structure_error(*a, **k):
        raise ValueError("KKT structure violation")
    monkeypatch.setattr(kkt_block, "BlockKKT", structure_error)
    p = build_brachistochrone(tast, "LGL3", 8)
    p.optimizer.set_PrintLevel(2)
    assert p.optimize() == 0
    assert isinstance(p.optimizer.kkt, DenseKKT)

    def other_error(*a, **k):
        raise RuntimeError("not a structure error")
    monkeypatch.setattr(kkt_block, "BlockKKT", other_error)
    p = build_brachistochrone(tast, "LGL3", 8)
    with pytest.raises(RuntimeError):
        p.transcribe()
