"""The rest of the vf namespace: every VectorFunction method, free
function, conditional and matrix operation ported in this slice, held to
the JAX package's counterpart on the same seeded input: value, Jacobian,
adjoint gradient and adjoint Hessian (the JAX package's jitted `compute`,
`jacobian`, `adjointgradient`, `adjointhessian`), to 1e-12 relative.
Infinite and NaN derivatives (arccos at 1 inside `ifelse`) must match
too."""

import zlib

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

TOL = 1e-12


def _cases():
    """name -> (builder(vf) -> function, input size, input range)."""
    def A(vf, n):
        return vf.Arguments(n)

    c = {
        # VectorFunction methods
        "strided": (lambda vf: A(vf, 7)[1:7:2] * A(vf, 7)[0:6:2], 7, None),
        "head2_tail3": (lambda vf: vf.stack(A(vf, 6).head2(),
                                            A(vf, 6).tail3() ** 2), 6, None),
        "head3_tail2": (lambda vf: vf.stack(A(vf, 6).head3(),
                                            A(vf, 6).tail2()), 6, None),
        "segment2_3": (lambda vf: vf.stack(A(vf, 6).segment2(1),
                                           A(vf, 6).segment3(2)), 6, None),
        "tolist_pairs": (lambda vf: vf.stack(
            [a * b for a, b in [A(vf, 6).tolist([(0, 3), (3, 3)])]]), 6,
            None),
        "abs": (lambda vf: abs(A(vf, 4) - 0.5), 4, None),
        "vf_abs": (lambda vf: vf.abs(A(vf, 4) - 0.5), 4, None),
        "sum": (lambda vf: (A(vf, 4) * A(vf, 4)).sum(), 4, None),
        "dot": (lambda vf: A(vf, 6).head3().dot(A(vf, 6).tail3()), 6, None),
        "cross": (lambda vf: A(vf, 6).head3().cross(A(vf, 6).tail3()), 6,
                  None),
        "cross_const": (lambda vf: A(vf, 3).cross(np.array([0, 0, 0.3])),
                        3, None),
        "cwiseProduct": (lambda vf: A(vf, 6).head3().cwiseProduct(
            A(vf, 6).tail3()), 6, None),
        "cwiseProduct_const": (lambda vf: A(vf, 3).cwiseProduct(
            [1.0, -2.0, 3.0]), 3, None),
        "cwiseQuotient": (lambda vf: A(vf, 6).head3().cwiseQuotient(
            A(vf, 6).tail3()), 6, None),
        "cwiseQuotient_const": (lambda vf: A(vf, 3).cwiseQuotient(
            [1.0, -2.0, 3.0]), 3, None),
        "norm": (lambda vf: A(vf, 4).norm(), 4, None),
        "squared": (lambda vf: A(vf, 4).squared(), 4, None),
        "squared_norm": (lambda vf: A(vf, 4).squared_norm(), 4, None),
        "inverse_norm": (lambda vf: A(vf, 4).inverse_norm(), 4, None),
        "normalized": (lambda vf: A(vf, 3).normalized(), 3, None),
        "normalized_power2": (lambda vf: A(vf, 3).normalized_power2(), 3,
                              None),
        "normalized_power3": (lambda vf: A(vf, 3).normalized_power3(), 3,
                              None),
        "normalized_power3_offset": (lambda vf: A(vf, 3).normalized_power3(
            np.array([0.1, -0.2, 0.3]), 2.5), 3, None),
        "normalized_power4": (lambda vf: A(vf, 3).normalized_power4(), 3,
                              None),
        "normalized_power5": (lambda vf: A(vf, 3).normalized_power5(), 3,
                              None),
        "padded": (lambda vf: A(vf, 3).padded_lower(2).padded_upper(1) * 2.0,
                   3, None),
        "sf_vf": (lambda vf: (A(vf, 2)[0].sf() * A(vf, 2)[1]).vf(), 2, None),
        "eval_idx": (lambda vf: (A(vf, 3).norm() * A(vf, 3)[0]).eval(
            8, [0, 2, 6]), 8, None),
        "ScalarFunction": (lambda vf: vf.ScalarFunction(
            A(vf, 3).squared_norm() * A(vf, 3)[2]) * 2.0, 3, None),
        # free functions
        "tan": (lambda vf: vf.tan(A(vf, 3)), 3, None),
        "arcsin": (lambda vf: vf.arcsin(A(vf, 3)), 3, None),
        "arccos": (lambda vf: vf.arccos(A(vf, 3)), 3, None),
        "arctan": (lambda vf: vf.arctan(A(vf, 3)), 3, None),
        "arctan2": (lambda vf: vf.arctan2(A(vf, 2)[0], A(vf, 2)[1] - 0.6),
                    2, None),
        "sinh_cosh_tanh": (lambda vf: vf.stack(
            vf.sinh(A(vf, 3)), vf.cosh(A(vf, 3)), vf.tanh(A(vf, 3))), 3,
            None),
        "sqrt_cbrt": (lambda vf: vf.stack(vf.sqrt(A(vf, 3)),
                                          vf.cbrt(A(vf, 3))), 3, None),
        "exp_log_log10": (lambda vf: vf.stack(
            vf.exp(A(vf, 3)), vf.log(A(vf, 3)), vf.log10(A(vf, 3))), 3,
            None),
        "sign_squared_cubed_inverse": (lambda vf: vf.stack(
            vf.sign(A(vf, 3) - 0.5) * A(vf, 3), vf.squared(A(vf, 3)),
            vf.cubed(A(vf, 3)), vf.inverse(A(vf, 3))), 3, None),
        "vf_sum": (lambda vf: vf.sum(A(vf, 3)[0], A(vf, 3)[1] ** 2, 1.5),
                   3, None),
        "SumElems": (lambda vf: vf.SumElems(A(vf, 3) ** 3), 3, None),
        "vf_dot_const": (lambda vf: vf.dot(A(vf, 3), [1.0, 2.0, 3.0]), 3,
                         None),
        "vf_cross_const": (lambda vf: vf.cross([0, 0, 1], A(vf, 3)), 3,
                           None),
        "doublecross": (lambda vf: vf.ops.doublecross(
            A(vf, 9).head3(), A(vf, 9).segment3(3), A(vf, 9).tail3()), 9,
            None),
        "normalize": (lambda vf: vf.normalize(A(vf, 3)), 3, None),
        "min_max": (lambda vf: vf.stack(vf.min(A(vf, 2)[0], A(vf, 2)[1]),
                                        vf.max(A(vf, 2)[0], A(vf, 2)[1])),
                    2, None),
        "quatProduct": (lambda vf: vf.quatProduct(A(vf, 8).head(4),
                                                  A(vf, 8).tail(4)), 8,
                        None),
        "quatRotate": (lambda vf: vf.quatRotate(A(vf, 7).head(4),
                                                A(vf, 7).tail3()), 7, None),
        "Scaled": (lambda vf: vf.Scaled(A(vf, 3) ** 2, 3.0), 3, None),
        "RowScaled": (lambda vf: vf.RowScaled(A(vf, 3) ** 2,
                                              [1.0, 2.0, 3.0]), 3, None),
        "IOScaled": (lambda vf: vf.IOScaled(A(vf, 3).normalized(),
                                            [1.0, 2.0, 0.5],
                                            [3.0, 1.0, 2.0]), 3, None),
        # conditionals
        "ifelse_lt": (lambda vf: vf.ifelse(A(vf, 2)[0] < 0.5,
                                           A(vf, 2) ** 2, A(vf, 2) * 3.0),
                      2, None),
        "ifelse_le_ge": (lambda vf: vf.ifelse(
            (A(vf, 2)[0] <= 0.5) | (A(vf, 2)[1] >= 0.6),
            vf.sin(A(vf, 2)), 1.0), 2, None),
        "ifelse_gt_and_not": (lambda vf: vf.ifelse(
            (A(vf, 2)[0] > A(vf, 2)[1]) & ~(A(vf, 2)[1] > 0.9),
            A(vf, 2)[0] * A(vf, 2)[1], A(vf, 2)[1] ** 3), 2, None),
        # arccos at 1 in the selected branch: infinite derivatives
        "ifelse_arccos_edge": (lambda vf: vf.ifelse(
            A(vf, 2)[0] > 0, vf.arccos(A(vf, 2)[1]),
            2 * np.pi - vf.arccos(A(vf, 2)[1])), 2, [0.5, 1.0]),
        # arccos at 1 in the branch not taken: NaN in the adjoint passes
        "ifelse_arccos_untaken": (lambda vf: vf.ifelse(
            A(vf, 2)[0] > 0, A(vf, 2)[1] * 2.0,
            vf.arccos(A(vf, 2)[1])), 2, [0.5, 1.0]),
        # matrices
        "inverse3": (lambda vf: vf.RowMatrix(
            A(vf, 9) + np.eye(3).ravel() * 2.0, 3, 3).inverse(), 9, None),
        "inverse4": (lambda vf: vf.RowMatrix(
            A(vf, 16) + np.eye(4).ravel() * 3.0, 4, 4).inverse(), 16, None),
        "ColMatrix_ops": (lambda vf: (vf.ColMatrix(A(vf, 4), 2, 2)
                                      .transpose() * 2.0
                                      + vf.RowMatrix(A(vf, 4), 2, 2)
                                      - np.eye(2)) * A(vf, 4).head2(), 4,
                          None),
        "determinant": (lambda vf: vf.RowMatrix(A(vf, 9), 3, 3)
                        .determinant(), 9, None),
    }
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_vf_op_matches_jax(name):
    build, n, point = CASES[name]
    fj, ft = build(jast.VectorFunctions), build(tast.VectorFunctions)
    assert (fj.IRows(), fj.ORows()) == (ft.IRows(), ft.ORows()) \
        and fj.IRows() == n
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = np.asarray(point, np.float64) if point is not None \
        else rng.uniform(0.2, 0.8, n)
    lam = rng.normal(size=fj.ORows())
    pairs = [(fj.compute(x), ft.compute(x)),
             (fj.jacobian(x), ft.jacobian(x)),
             (fj.adjointgradient(x, lam), ft.adjointgradient(x, lam)),
             (fj.adjointhessian(x, lam), ft.adjointhessian(x, lam))]
    for what, (a, b) in zip(("value", "jacobian", "adjointgradient",
                             "adjointhessian"), pairs):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, what
        fin = np.isfinite(a)
        assert np.array_equal(fin, np.isfinite(b)), what
        assert np.array_equal(a[~fin], b[~fin], equal_nan=True), what
        scale = max(1.0, np.abs(a[fin]).max(initial=0.0))
        assert np.abs(a[fin] - b[fin]).max(initial=0.0) <= TOL * scale, what


def test_conditional_compute():
    """ConditionalFunction.compute: the boolean predicate itself."""
    for vf in (jast.VectorFunctions, tast.VectorFunctions):
        a = vf.Arguments(2)
        c = (a[0] < 0.5) & ~(a[1] >= 0.7)
        assert c.compute([0.2, 0.3]) is True
        assert c.compute([0.2, 0.8]) is False
        assert ((a[0] > a[1]) | (a[1] <= 0.1)).compute([0.6, 0.5]) is True
