"""Kernel K1 (batched Gauss-Jordan inverse + pivots + inertia epilogue):
the port's plain PyTorch versions (unblocked, and the blocked panel
algorithm of the wide kernel) against the JAX package's f64 XLA loop, f32
Pallas kernel (interpret mode) and `_inv_sym` count, at block widths of
the band (up to 64) and of a multi-phase border (above 64), and the CUDA
kernels (narrow and wide) against the plain versions on a card."""

import jax
import numpy as np
import pytest
import torch

from asset_asrl_tpu.Solvers.kkt_block import _inv_gj_pivots
from asset_asrl_tpu.Solvers.kkt_block import _inv_sym as jax_inv_sym
from asset_asrl_tpu.Solvers.pallas_kernels import batched_gj_inverse
from asset_asrl_torch.Solvers.cuda_kernels import (
    gj_inverse, gj_inverse_blocked_ref, gj_inverse_inertia, gj_inverse_ref)
from asset_asrl_torch.Solvers.kkt_block import _inv_sym

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

SHAPES = [(1, 2), (5, 24), (64, 24), (3, 7)]
# border widths: the wide kernel's shared-memory (<= 169 in f64) and
# global-memory variants
WIDE_SHAPES = [(1, 85), (2, 130)]
CUDA_WIDE_SHAPES = [(1, 85), (1, 160), (1, 255), (2, 511)]
# the blocked version: one panel plus one column, ragged and even panel
# counts, the borders of 80 and 256 segments a phase
BLOCKED_SHAPES = [(2, 65), (1, 85), (2, 130), (1, 261), (3, 77)]
# every variant of the narrow kernels (one warp up to 32, two warps up to
# 64; 16-byte and 8-byte aligned blocks) and the shapes of the 10^4-node
# problems' first reduction level
CUDA_NARROW_SHAPES = [(1, 1), (514, 8), (25, 11), (2500, 24), (156, 24),
                      (2501, 25), (13, 27), (3, 32), (3, 33), (65, 42),
                      (2, 63), (3, 64)]
CUDA_BLOCKED_SHAPES = [(1, 65), (1, 261), (2, 511), (1, 517), (1, 1029)]


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


@pytest.mark.parametrize("K,W", BLOCKED_SHAPES)
def test_blocked_ref_matches_unblocked(K, W):
    """The panel algorithm of the wide kernel against the unblocked
    elimination: 1e-12 relative and equal pivot signs (its pivots are sums
    taken in another order, so not bitwise equal)."""
    A = torch.tensor(blocks(K, W, seed=K * 100 + W), dtype=torch.float64)
    X, p = gj_inverse_ref(A)
    Xb, pb = gj_inverse_blocked_ref(A, 32)
    assert rel(Xb.numpy(), X.numpy()) < 1e-12
    assert rel(pb.numpy(), p.numpy()) < 1e-12
    assert torch.equal(torch.sign(pb), torch.sign(p))
    assert np.abs(Xb.numpy() @ A.numpy() - np.eye(W)).max() < 1e-10


@pytest.mark.parametrize("K,W", BLOCKED_SHAPES)
def test_blocked_ref_matches_inv_gj_pivots(K, W):
    A = blocks(K, W, seed=K * 100 + W + 2)
    Xj, pj = jax.jit(_inv_gj_pivots)(A)
    Xb, pb = gj_inverse_blocked_ref(torch.tensor(A, dtype=torch.float64))
    Xj, pj = np.asarray(Xj), np.asarray(pj)
    assert rel(Xb.numpy(), Xj) < 1e-12
    assert rel(pb.numpy(), pj) < 1e-12
    assert np.array_equal(np.sign(pb.numpy()), np.sign(pj))


@pytest.mark.parametrize("nb", [8, 32, 100])
def test_blocked_ref_any_panel_width(nb):
    """Panels narrower than, equal to and wider than the block."""
    A = torch.tensor(blocks(2, 70, seed=nb), dtype=torch.float64)
    X, p = gj_inverse_ref(A)
    Xb, pb = gj_inverse_blocked_ref(A, nb)
    assert rel(Xb.numpy(), X.numpy()) < 1e-12
    assert rel(pb.numpy(), p.numpy()) < 1e-12


def bad_pivot_blocks(K, W, seed):
    """Quasi-definite blocks whose block 1 has a zero pivot (row and
    column W // 3 zeroed) and a NaN pivot (row and column W // 2 zeroed
    but for a NaN on the diagonal)."""
    A = blocks(K, W, seed)
    zero, nan = W // 3, W // 2
    A[1, [zero, nan], :] = 0.0
    A[1, :, [zero, nan]] = 0.0
    A[1, nan, nan] = np.nan
    return A, zero, nan


@pytest.mark.parametrize("W", [70, 130])
def test_blocked_ref_reports_zero_and_nan_pivot(W):
    """A zero and a NaN pivot come out of the blocked version where the
    unblocked one reports them, whichever panel holds them."""
    A, zero, nan = bad_pivot_blocks(2, W, seed=W)
    A = torch.tensor(A, dtype=torch.float64)
    X, p = gj_inverse_ref(A)
    Xb, pb = gj_inverse_blocked_ref(A, 32)
    assert pb[1, zero].item() == 0.0 and torch.isnan(pb[1, nan])
    assert torch.equal(torch.isnan(pb), torch.isnan(p))
    ok = ~torch.isnan(p)
    assert rel(pb[ok].numpy(), p[ok].numpy()) < 1e-12
    assert torch.equal(torch.sign(pb[ok]), torch.sign(p[ok]))
    assert rel(Xb[0].numpy(), X[0].numpy()) < 1e-12


@pytest.mark.parametrize("K,W", SHAPES + WIDE_SHAPES)
def test_inertia_matches_jax_inv_sym(K, W):
    """`gj_inverse_inertia` on the CPU (and `_inv_sym`, its caller in the
    factorization) against the JAX package's `_inv_sym`: the same inverse
    and the same count of negative pivots."""
    A = blocks(K, W, seed=K * 100 + W + 3)
    Xj, negj = jax.jit(jax_inv_sym)(A)
    D = torch.tensor(A, dtype=torch.float64)
    X, p, nbad = gj_inverse_inertia(D)
    assert nbad.shape == (K,) and nbad.dtype == torch.int32
    assert int(nbad.sum()) == int(negj) == K * (W - (W + 1) // 2)
    assert torch.equal(nbad, (p < 0).sum(1).to(torch.int32))
    assert rel(X.numpy(), np.asarray(Xj)) < 1e-12
    Xs, neg = _inv_sym(D)
    assert int(neg) == int(negj) and torch.equal(Xs, X)


@pytest.mark.parametrize("W", [6, 24, 70])
def test_inertia_counts_zero_and_nan_pivot(W):
    """A zero and a NaN pivot each count as bad, as in the JAX package's
    `_inv_sym`, and the inverse comes back finite."""
    A, zero, nan = bad_pivot_blocks(3, W, seed=W)
    Xj, negj = jax.jit(jax_inv_sym)(A)
    X, p, nbad = gj_inverse_inertia(torch.tensor(A, dtype=torch.float64))
    clean = W - (W + 1) // 2
    neg1 = int((p[1] < 0).sum())
    assert nbad.tolist() == [clean, neg1 + 2, clean]
    assert int(nbad.sum()) == int(negj)
    assert p[1, zero].item() == 0.0 and torch.isnan(p[1, nan])
    assert torch.isfinite(X).all()
    assert rel(X.numpy(), np.asarray(Xj)) < 1e-12


def test_inertia_f32_uses_f32_threshold():
    """|pivot| below 1e-25 counts as bad in f32, 1e-250 in f64."""
    A = np.diag([1.0, 1e-30, 2.0])[None]
    assert gj_inverse_inertia(
        torch.tensor(A, dtype=torch.float32))[2].tolist() == [1]
    assert gj_inverse_inertia(
        torch.tensor(A, dtype=torch.float64))[2].tolist() == [0]


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


def on_card(K, W, dtype, seed=None):
    return torch.tensor(blocks(K, W, seed=K + W if seed is None else seed),
                        dtype=dtype, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_cuda_narrow_kernels_every_variant(dtype, tol):
    """The one-warp (W <= 32) and two-warp (W <= 64) kernels with the
    fused epilogue: plain version's inverse and pivots, the plain count,
    and a second run bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for K, W in CUDA_NARROW_SHAPES:
        D = on_card(K, W, dtype)
        before = (gj_inverse.launches, gj_inverse.wide_launches)
        X, p, nbad = gj_inverse_inertia(D)
        X2, p2, nbad2 = gj_inverse_inertia(D)
        Xr, pr = gj_inverse_ref(D)
        torch.cuda.synchronize()
        assert (gj_inverse.launches, gj_inverse.wide_launches) == \
            (before[0] + 2, before[1])
        assert float((X - Xr).norm() / Xr.norm()) < tol
        assert float((p - pr).norm() / pr.norm()) < tol
        assert torch.equal(torch.sign(p), torch.sign(pr))
        assert torch.equal(nbad.long(), (pr < 0).sum(1))
        assert torch.equal(X, X2) and torch.equal(p, p2)
        assert torch.equal(nbad, nbad2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-4)])
def test_cuda_blocked_kernel_matches_both_plain_versions(dtype, tol):
    """The wide kernel against the unblocked plain version (equal to
    rounding: its pivots are sums taken in another order; signs equal) and
    against the blocked plain version, whose steps it repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for K, W in CUDA_BLOCKED_SHAPES:
        D = on_card(K, W, dtype)
        X, p, nbad = gj_inverse_inertia(D)
        X2, p2, nbad2 = gj_inverse_inertia(D)
        torch.cuda.synchronize()
        for Xr, pr in (gj_inverse_ref(D), gj_inverse_blocked_ref(D)):
            assert float((X - Xr).norm() / Xr.norm()) < tol
            assert float((p - pr).norm() / pr.norm()) < tol
            assert torch.equal(torch.sign(p), torch.sign(pr))
        assert torch.equal(nbad.long(), (pr < 0).sum(1))
        assert torch.equal(X, X2) and torch.equal(p, p2)
        assert torch.equal(nbad, nbad2)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [6, 24, 40, 70, 261])
def test_cuda_epilogue_counts_zero_and_nan_pivot(W):
    """The fused epilogue on a block with a zero and a NaN pivot: the
    plain count, both pivots reported, the inverse finite and equal to the
    CPU branch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        A, zero, nan = bad_pivot_blocks(3, W, seed=W)
        D = torch.tensor(A, dtype=dtype)
        Xr, pr, nbad_r = gj_inverse_inertia(D)
        X, p, nbad = gj_inverse_inertia(D.cuda())
        assert torch.equal(nbad.cpu(), nbad_r)
        assert p[1, zero].item() == 0.0 and torch.isnan(p[1, nan])
        assert torch.isfinite(X).all()
        assert float((X.cpu() - Xr).norm() / Xr.norm()) < tol
        Xraw, praw = gj_inverse(D.cuda())
        assert torch.equal(torch.isnan(praw), torch.isnan(p))


@pytest.mark.cuda
def test_cuda_misaligned_input_is_copied():
    """A contiguous view that starts 8 bytes into its storage still goes
    through the kernel (which loads 16 bytes a thread) and gives the same
    result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    D = on_card(4, 24, torch.float64)
    buf = torch.empty(D.numel() + 1, dtype=D.dtype, device="cuda")
    view = buf[1:].view_as(D).copy_(D)
    assert view.data_ptr() % 16 == 8
    X, p = gj_inverse(D)
    Xv, pv = gj_inverse(view)
    assert torch.equal(X, Xv) and torch.equal(p, pv)
