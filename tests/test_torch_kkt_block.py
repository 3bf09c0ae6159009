"""Block KKT parity: the port's BCR against dense linear algebra, and its
structure, assembly, factorization and solve against the JAX package's
BlockKKT on the CartPole problem (reference calls jitted)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_torch.interop import blocks_from_numpy, state_from_numpy
from asset_asrl_torch.Solvers.kkt_block import bcr_factor, bcr_solve
from chip_smoke import build_cartpole

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


def make_block_tridiag(K, W, b, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=(K, W, W))
    diag = (diag + diag.transpose(0, 2, 1)) / 2
    if spd:
        for k in range(K):
            diag[k] += W * np.eye(W)
    lower = rng.normal(size=(K, W, W)) * 0.3
    lower[-1] = 0.0
    B = rng.normal(size=(K, W, b)) * 0.2
    C = rng.normal(size=(b, b))
    C = (C + C.T) / 2 - b * np.eye(b)
    dim = K * W + b
    A = np.zeros((dim, dim))
    for k in range(K):
        A[k * W:(k + 1) * W, k * W:(k + 1) * W] = diag[k]
        if k + 1 < K:
            A[(k + 1) * W:(k + 2) * W, k * W:(k + 1) * W] = lower[k]
            A[k * W:(k + 1) * W, (k + 1) * W:(k + 2) * W] = lower[k].T
        A[k * W:(k + 1) * W, K * W:] = B[k]
        A[K * W:, k * W:(k + 1) * W] = B[k].T
    A[K * W:, K * W:] = C
    return diag, lower, B, C, A


def one_lane(*ts):
    """One problem as a batch of one lane (the BCR functions' layout)."""
    return [t[None] for t in ts]


@pytest.mark.parametrize("K,W,b", [(1, 3, 2), (2, 3, 2), (5, 4, 3),
                                   (8, 4, 0), (13, 5, 4), (16, 2, 1)])
def test_bcr_solve_matches_dense(K, W, b):
    diag, lower, B, C, A = make_block_tridiag(K, W, b, seed=K + W, spd=True)
    fac, neigs = bcr_factor(*one_lane(*blocks_from_numpy(diag, lower, B, C,
                                                         "cpu")))
    rng = np.random.default_rng(1)
    r = rng.normal(size=(K, W))
    rb = rng.normal(size=(b,))
    y, z = bcr_solve(fac, *one_lane(torch.tensor(r), torch.tensor(rb)))
    sol = np.linalg.solve(A, np.concatenate([r.ravel(), rb]))
    got = np.concatenate([y[0].numpy().ravel(), z[0].numpy()])
    assert np.allclose(got, sol, atol=1e-8), np.abs(got - sol).max()


@pytest.mark.parametrize("K,W,b", [(4, 3, 2), (7, 4, 3), (16, 3, 0)])
def test_bcr_inertia(K, W, b):
    for seed in range(4):
        diag, lower, B, C, A = make_block_tridiag(K, W, b, seed=seed)
        _, neigs = bcr_factor(*one_lane(*blocks_from_numpy(diag, lower, B,
                                                           C, "cpu")))
        assert int(neigs[0]) == int(np.sum(np.linalg.eigvalsh(A) < 0)), seed


@pytest.mark.parametrize("K,W,b", [(7, 4, 3), (16, 3, 0), (13, 5, 2)])
def test_bcr_batched_lanes_match_single(K, W, b):
    """A batch of B problems of one structure factored and solved in one
    call: each lane's inertia (per lane, from one K1 launch a level) and
    solution equal those of the lane factored alone."""
    mats = [make_block_tridiag(K, W, b, seed=s, spd=s % 2 == 0)
            for s in range(4)]
    rng = np.random.default_rng(2)
    rs = rng.normal(size=(4, K, W))
    rbs = rng.normal(size=(4, b))
    lanes = [torch.stack(a) for a in zip(*(blocks_from_numpy(
        *m[:4], "cpu") for m in mats))]
    fac, neigs = bcr_factor(*lanes)
    assert neigs.shape == (4,)
    y, z = bcr_solve(fac, torch.tensor(rs), torch.tensor(rbs))
    for i, m in enumerate(mats):
        fi, ni = bcr_factor(*one_lane(*blocks_from_numpy(*m[:4], "cpu")))
        assert int(neigs[i]) == int(ni[0]) == int(
            np.sum(np.linalg.eigvalsh(m[4]) < 0)), i
        yi, zi = (a[0] for a in bcr_solve(
            fi, *one_lane(torch.tensor(rs[i]), torch.tensor(rbs[i]))))
        scale = max(1.0, float(yi.abs().max()))
        assert float((y[i] - yi).abs().max()) <= 1e-12 * scale, i
        assert np.abs((z[i] - zi).numpy()).max(initial=0.0) <= 1e-12 * scale


@pytest.fixture(scope="module")
def cartpole():
    """Both packages' CartPole (40 segments), transcribed, with one seeded
    iterate near the initial guess."""
    pj = build_cartpole(jast, 40)
    pj.optimizer.set_PrintLevel(2)
    pj.transcribe()
    pt = build_cartpole(tast, 40)
    pt.transcribe()
    kj, kt = pj.optimizer.kkt, pt.optimizer.kkt
    nlp = kj.nlp
    rng = np.random.default_rng(5)
    x = pj.makeSolverInput() + 0.01 * rng.normal(size=nlp.numPrimal)
    lamE = 0.1 * rng.normal(size=nlp.numEq)
    lamI = 0.05 + 0.1 * rng.random(nlp.numIq)
    s = 0.1 + rng.random(nlp.numIq)
    sig_tilde = lamI / s
    return kj, kt, (x, s, lamE, lamI), sig_tilde


def jax_blocks(kj, state, sig_tilde):
    x, _, lamE, lamI = (jnp.asarray(a) for a in state)
    _, _, _, _, fam = jax.jit(kj._ad_impl)(
        x, lamE, lamI, jnp.asarray(1.0), kj.nlp.consts_dev())
    return jax.jit(kj._blocks_impl)(fam, jnp.asarray(sig_tilde))


def test_structure_and_tables_identical(cartpole):
    kj, kt, _, _ = cartpole
    for a in ("K", "W", "b", "q", "mE", "n"):
        assert getattr(kj.bs, a) == getattr(kt.bs, a), a
    assert (kt.bs.K, kt.bs.W, kt.bs.b) == (41, 24, 2)
    assert np.array_equal(kj._perm, kt._perm.numpy())
    for fj, ft in zip(kj._eq + kj._iq + kj._obj, kt._eq + kt._iq + kt._obj):
        assert np.array_equal(fj["jnz"], ft["jnz"])
        assert np.array_equal(fj["hnz"], ft["hnz"])
    assert np.array_equal(np.asarray(kj._trd), kt._trd.numpy())
    # the JAX package keeps the C table as (b, b, width)
    assert np.array_equal(np.asarray(kj._tC).reshape(kt._tC.shape),
                          kt._tC.numpy())


def test_residuals_match(cartpole):
    kj, kt, state, _ = cartpole
    x, _, lamE, lamI = state
    rj = kj.eval_resid(jnp.asarray(x), jnp.asarray(lamE), jnp.asarray(lamI),
                       1.0)
    xt, _, lEt, lIt = state_from_numpy(*state, device="cpu")
    rt = kt.eval_resid(xt, lEt, lIt, 1.0)
    for a, b in zip(rj, rt):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-12 * max(1.0,
                                                            np.abs(a).max())


def test_assembled_blocks_match(cartpole):
    kj, kt, state, sig_tilde = cartpole
    bj = jax_blocks(kj, state, sig_tilde)
    xt, _, lEt, lIt = state_from_numpy(*state, device="cpu")
    _, _, _, _, fam = kt._eval_core(*one_lane(xt, lEt, lIt), 1.0,
                                    kt.nlp.consts_dev(), want_hess=True)
    bt = kt._blocks_impl(fam, torch.tensor(sig_tilde)[None])
    for a, b in zip(bj, bt):
        a, b = np.asarray(a), b[0]
        assert a.shape == tuple(b.shape)
        assert np.abs(a - b.numpy()).max() <= 1e-12 * np.abs(a).max()


def factor_both(kj, kt, bj, delta, gamma):
    facj, negj = jax.jit(kj._factor_blocks_impl)(
        bj, jnp.asarray(delta), jnp.asarray(gamma))
    fact, negt = kt._factor_blocks_impl(
        one_lane(*blocks_from_numpy(*(np.asarray(a) for a in bj),
                                    device="cpu")),
        delta, gamma)
    return facj, int(negj), fact, int(negt[0])


@pytest.mark.parametrize("delta", [0.0, 1e-4, 1e-2])
def test_inertia_on_jax_blocks(cartpole, delta):
    kj, kt, state, sig_tilde = cartpole
    bj = jax_blocks(kj, state, sig_tilde)
    _, negj, _, negt = factor_both(kj, kt, bj, delta, 1e-10)
    assert negt == negj


def test_solve_on_jax_blocks(cartpole):
    """At a regularization the ladder accepts (inertia = mE), the port's
    factor + solve of the JAX package's blocks matches the JAX solve.
    (Where the inertia is wrong, the unpivoted elimination of the
    indefinite blocks amplifies rounding and the two differ near 1e-8.)"""
    kj, kt, state, sig_tilde = cartpole
    bj = jax_blocks(kj, state, sig_tilde)
    facj, negj, fact, negt = factor_both(kj, kt, bj, 1e-2, 1e-4)
    assert negt == negj == kt.nlp.numEq
    rng = np.random.default_rng(11)
    rx = rng.normal(size=kt.nlp.numPrimal)
    rE = rng.normal(size=kt.nlp.numEq)
    dxj, dlj = jax.jit(kj._solve_impl)(facj, jnp.asarray(rx), jnp.asarray(rE))
    dxt, dlt = kt.solve(fact, torch.tensor(rx), torch.tensor(rE))
    ref = np.concatenate([np.asarray(dxj), np.asarray(dlj)])
    got = np.concatenate([dxt.numpy(), dlt.numpy()])
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


def test_iq_matvecs_match(cartpole):
    kj, kt, state, sig_tilde = cartpole
    xt, _, lEt, lIt = state_from_numpy(*state, device="cpu")
    fac, _ = kt.factor(xt, lEt, lIt, 1.0, torch.tensor(sig_tilde), 1e-4,
                       1e-10)
    facj, _ = kj.factor(*(jnp.asarray(a) for a in (state[0], state[2],
                                                   state[3])),
                        1.0, jnp.asarray(sig_tilde), 1e-4, 1e-10)
    rng = np.random.default_rng(3)
    dx = rng.normal(size=kt.nlp.numPrimal)
    v = rng.normal(size=kt.nlp.numIq)
    a = np.asarray(kj.iq_matvec(facj, jnp.asarray(dx)))
    b = kt.iq_matvec(fac, torch.tensor(dx)).numpy()
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()
    a = np.asarray(kj.iq_rmatvec(facj, jnp.asarray(v)))
    b = kt.iq_rmatvec(fac, torch.tensor(v)).numpy()
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()
