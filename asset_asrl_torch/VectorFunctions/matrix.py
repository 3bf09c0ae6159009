"""Runtime matrix functions inside expressions (vf.RowMatrix).

Port of the part of `asset_asrl_tpu/VectorFunctions/matrix.py` that the
CartPole path reaches.  A MatrixFunction is a VectorFunction whose output
is the column-major flattening of a (rows x cols) matrix; matrix semantics
live in its operators.  Usage pattern (CartPole):
``M = vf.RowMatrix(vec, 2, 2); xdd = M.inverse() * Q``.
"""

from __future__ import annotations

import torch

from .function import VectorFunction, as_function

__all__ = ["MatrixFunction", "RowMatrix"]


def _inv2(M):
    # torch.stack, not torch.tensor: tensor() would detach the entries and
    # break jacfwd/vmap
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    return torch.stack([torch.stack([M[1, 1], -M[0, 1]]),
                        torch.stack([-M[1, 0], M[0, 0]])]) / det


class MatrixFunction(VectorFunction):
    """VectorFunction with matrix structure; flattened output is
    column-major."""

    def __init__(self, fn_mat, irows, rows, cols, name="MatrixFunction"):
        self._fm = fn_mat
        self.rows, self.cols = int(rows), int(cols)
        super().__init__(lambda x: fn_mat(x).transpose(0, 1).reshape(-1),
                         irows, self.rows * self.cols, name=name)

    def __mul__(self, other):
        """Matrix product with a MatrixFunction, matrix-vector product with
        a VectorFunction, or scaling by a scalar function."""
        fm = self._fm
        if isinstance(other, MatrixFunction):
            if other.rows != self.cols or other.IRows() != self.IRows():
                raise ValueError("matrix product size mismatch")
            gm = other._fm
            return MatrixFunction(lambda x: fm(x) @ gm(x), self.IRows(),
                                  self.rows, other.cols, name="matprod")
        if isinstance(other, VectorFunction):
            g = other._fn
            if other.ORows() == 1:
                return MatrixFunction(
                    lambda x: fm(x) * torch.atleast_1d(g(x))[0],
                    self.IRows(), self.rows, self.cols, name="matscale")
            if other.ORows() != self.cols or other.IRows() != self.IRows():
                raise ValueError("matrix-vector product size mismatch")
            return VectorFunction(
                lambda x: fm(x) @ torch.atleast_1d(g(x)),
                self.IRows(), self.rows, name="matvec")
        return NotImplemented

    def inverse(self):
        """Closed-form inverse of a 1x1 or 2x2 matrix."""
        if self.rows != self.cols:
            raise ValueError("inverse requires a square matrix")
        if self.rows == 1:
            inv = lambda M: 1.0 / M  # noqa: E731
        elif self.rows == 2:
            inv = _inv2
        else:
            raise NotImplementedError(
                "MatrixFunction.inverse above 2x2 is not ported yet "
                "(ROADMAP queue 1, item 12)")
        fm = self._fm
        return MatrixFunction(lambda x: inv(fm(x)), self.IRows(),
                              self.rows, self.cols, name="matinv")


def RowMatrix(func, rows, cols):
    """Interpret func's output as a (rows, cols) matrix stored row-major."""
    func = as_function(func) if not isinstance(func, VectorFunction) \
        else func
    rows, cols = int(rows), int(cols)
    if func.ORows() != rows * cols:
        raise ValueError("RowMatrix: output size != rows*cols")
    f = func._fn
    return MatrixFunction(
        lambda x: torch.atleast_1d(f(x)).reshape(rows, cols),
        func.IRows(), rows, cols, name="RowMatrix")
