"""Kernel K1 (batched Gauss-Jordan inverse + pivots): the port's plain
PyTorch version against the JAX package's f64 XLA loop and f32 Pallas
kernel (interpret mode), at block widths of the band (up to 64) and of a
multi-phase border (above 64), and the CUDA kernels (narrow and wide)
against the plain version on a card."""

import jax
import numpy as np
import pytest
import torch

from asset_asrl_tpu.Solvers.kkt_block import _inv_gj_pivots
from asset_asrl_tpu.Solvers.pallas_kernels import batched_gj_inverse
from asset_asrl_torch.Solvers.cuda_kernels import gj_inverse, gj_inverse_ref

torch.set_num_threads(2)

SHAPES = [(1, 2), (5, 24), (64, 24), (3, 7)]
# border widths: the wide kernel's shared-memory (<= 169 in f64) and
# global-memory variants
WIDE_SHAPES = [(1, 85), (2, 130)]
CUDA_WIDE_SHAPES = [(1, 85), (1, 160), (1, 255), (2, 511)]


def blocks(K, W, seed):
    """Seeded symmetric quasi-definite blocks (positive leading half,
    negative trailing half), as the regularized KKT blocks are."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, W, W))
    A = (A + A.transpose(0, 2, 1)) / 2
    h = (W + 1) // 2
    A[:, :h, :h] += W * np.eye(h)
    A[:, h:, h:] -= W * np.eye(W - h)
    return A


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("K,W", SHAPES + WIDE_SHAPES)
def test_ref_f64_matches_inv_gj_pivots(K, W):
    A = blocks(K, W, seed=K * 100 + W)
    Xj, pj = jax.jit(_inv_gj_pivots)(A)
    Xt, pt = gj_inverse_ref(torch.tensor(A, dtype=torch.float64))
    Xj, pj = np.asarray(Xj), np.asarray(pj)
    assert rel(Xt.numpy(), Xj) < 1e-12
    assert rel(pt.numpy(), pj) < 1e-12
    assert np.array_equal(np.sign(pt.numpy()), np.sign(pj))
    assert np.abs(Xt.numpy() @ A - np.eye(W)).max() < 1e-10


@pytest.mark.parametrize("K,W", SHAPES)
def test_ref_f32_matches_pallas_interpret(K, W):
    A = blocks(K, W, seed=K * 100 + W + 1).astype(np.float32)
    Xj, pj = jax.jit(lambda d: batched_gj_inverse(d, interpret=True))(A)
    Xt, pt = gj_inverse_ref(torch.tensor(A, dtype=torch.float32))
    assert Xt.dtype == torch.float32 and pt.dtype == torch.float32
    Xj, pj = np.asarray(Xj), np.asarray(pj)
    assert rel(Xt.numpy(), Xj) < 1e-4
    assert rel(pt.numpy(), pj) < 1e-4
    assert np.array_equal(np.sign(pt.numpy()), np.sign(pj))


def test_zero_pivot_is_reported():
    """A singular block keeps its zero pivot in `pivs` (the guard only
    protects the division), so the inertia count sees it."""
    A = np.zeros((1, 3, 3))
    A[0, 1, 1], A[0, 2, 2] = 2.0, -1.0
    _, p = gj_inverse(torch.tensor(A, dtype=torch.float64))
    assert p[0, 0].item() == 0.0
    assert p[0, 1].item() == 2.0 and p[0, 2].item() == -1.0


def test_cpu_tensor_takes_plain_path():
    A = torch.tensor(blocks(4, 6, seed=3), dtype=torch.float64)
    before = gj_inverse.launches
    X, p = gj_inverse(A)
    Xr, pr = gj_inverse_ref(A)
    assert gj_inverse.launches == before
    assert torch.equal(X, Xr) and torch.equal(p, pr)


@pytest.mark.parametrize("W", [65, 130])
def test_cpu_wide_tensor_takes_plain_path(W):
    """Wider than the narrow kernel: a CPU tensor still goes to the plain
    version and counts no launch of either kernel."""
    A = torch.tensor(blocks(2, W, seed=3), dtype=torch.float64)
    before = (gj_inverse.launches, gj_inverse.wide_launches)
    X, p = gj_inverse(A)
    Xr, pr = gj_inverse_ref(A)
    assert (gj_inverse.launches, gj_inverse.wide_launches) == before
    assert torch.equal(X, Xr) and torch.equal(p, pr)


@pytest.mark.parametrize("bad", ["empty", "dtype", "rank"])
def test_rejects_unsupported_input(bad):
    D = {"empty": torch.zeros((1, 0, 0), dtype=torch.float64),
         "dtype": torch.zeros((1, 4, 4), dtype=torch.int64),
         "rank": torch.zeros((4, 4), dtype=torch.float64)}[bad]
    with pytest.raises(ValueError):
        gj_inverse(D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_cuda_kernel_matches_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for K, W in SHAPES + [(2500, 24), (3, 64)]:
        D = torch.tensor(blocks(K, W, seed=K + W), dtype=dtype,
                         device="cuda")
        before = gj_inverse.launches
        X, p = gj_inverse(D)
        Xr, pr = gj_inverse_ref(D)
        torch.cuda.synchronize()
        assert gj_inverse.launches == before + 1
        assert float((X - Xr).norm() / Xr.norm()) < tol
        assert float((p - pr).norm() / pr.norm()) < tol
        assert torch.equal(torch.sign(p), torch.sign(pr))
    with pytest.raises(ValueError):
        gj_inverse(torch.zeros((2, 8, 8), dtype=dtype,
                               device="cuda").transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_cuda_wide_kernel_matches_plain(dtype, tol):
    """Blocks wider than 64 launch the wide kernel (and only it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for K, W in CUDA_WIDE_SHAPES:
        D = torch.tensor(blocks(K, W, seed=K + W), dtype=dtype,
                         device="cuda")
        before = (gj_inverse.launches, gj_inverse.wide_launches)
        X, p = gj_inverse(D)
        Xr, pr = gj_inverse_ref(D)
        torch.cuda.synchronize()
        assert (gj_inverse.launches, gj_inverse.wide_launches) == \
            (before[0], before[1] + 1)
        assert float((X - Xr).norm() / Xr.norm()) < tol
        assert float((p - pr).norm() / pr.norm()) < tol
        assert torch.equal(torch.sign(p), torch.sign(pr))
