"""Runtime matrix functions inside expressions (vf.RowMatrix / vf.ColMatrix).

Port of `asset_asrl_tpu/VectorFunctions/matrix.py`.  A MatrixFunction is a
VectorFunction whose output is the column-major flattening of a
(rows x cols) matrix; matrix semantics live in its operators.  Usage
pattern (CartPole): ``M = vf.RowMatrix(vec, 2, 2); xdd = M.inverse() * Q``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from .function import VectorFunction, _cross, _is_numericlike, as_function

__all__ = ["MatrixFunction", "RowMatrix", "ColMatrix"]


def _inv2(M):
    # torch.stack, not torch.tensor: tensor() would detach the entries and
    # break jacfwd/vmap
    det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    return torch.stack([torch.stack([M[1, 1], -M[0, 1]]),
                        torch.stack([-M[1, 0], M[0, 0]])]) / det


def _inv3(M):
    """Cofactor inverse: rows are the cross products of column pairs."""
    c0 = _cross(M[:, 1], M[:, 2])
    c1 = _cross(M[:, 2], M[:, 0])
    c2 = _cross(M[:, 0], M[:, 1])
    det = torch.sum(M[:, 0] * c0)
    return torch.stack([c0, c1, c2]) / det


class MatrixFunction(VectorFunction):
    """VectorFunction with matrix structure; flattened output is
    column-major."""

    def __init__(self, fn_mat, irows, rows, cols, name="MatrixFunction"):
        self._fm = fn_mat
        self.rows, self.cols = int(rows), int(cols)
        super().__init__(lambda x: fn_mat(x).transpose(0, 1).reshape(-1),
                         irows, self.rows * self.cols, name=name)

    def matrix(self, x):
        """The (rows, cols) matrix value at tensor x."""
        return self._fm(x)

    # -------------------------------------------------------------- operators
    def __mul__(self, other):
        """Matrix product with a MatrixFunction or constant matrix,
        matrix-vector product with a VectorFunction or constant vector,
        or scaling by a scalar function or number."""
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
        if _is_numericlike(other):
            a = np.asarray(other, dtype=np.float64)
            if a.ndim == 0 or a.size == 1:
                s = float(a.ravel()[0])
                return MatrixFunction(lambda x: fm(x) * s, self.IRows(),
                                      self.rows, self.cols, name="matscale")
            if a.shape[0] != self.cols:
                raise ValueError("matrix product size mismatch")
            at = config.tensor(a)
            if a.ndim == 1:
                return VectorFunction(lambda x: fm(x) @ at, self.IRows(),
                                      self.rows, name="matvec")
            return MatrixFunction(lambda x: fm(x) @ at, self.IRows(),
                                  self.rows, a.shape[1], name="matprod")
        return NotImplemented

    def __rmul__(self, other):
        fm = self._fm
        if _is_numericlike(other) and not isinstance(other, VectorFunction):
            a = np.asarray(other, dtype=np.float64)
            if a.ndim == 0 or a.size == 1:
                s = float(a.ravel()[0])
                return MatrixFunction(lambda x: fm(x) * s, self.IRows(),
                                      self.rows, self.cols, name="matscale")
            at = config.tensor(np.atleast_2d(a))
            if at.shape[1] != self.rows:
                raise ValueError("matrix product size mismatch")
            return MatrixFunction(lambda x: at @ fm(x), self.IRows(),
                                  at.shape[0], self.cols, name="matprod")
        if isinstance(other, VectorFunction) and other.ORows() == 1:
            g = other._fn
            return MatrixFunction(
                lambda x: fm(x) * torch.atleast_1d(g(x))[0],
                self.IRows(), self.rows, self.cols, name="matscale")
        return NotImplemented

    def _mat_add(self, other, sub=False, reverse=False):
        fm = self._fm
        op = torch.sub if sub else torch.add
        if isinstance(other, MatrixFunction):
            if (other.rows, other.cols) != (self.rows, self.cols):
                raise ValueError("matrix sum size mismatch")
            gm = other._fm
            if reverse:
                return MatrixFunction(lambda x: op(gm(x), fm(x)),
                                      self.IRows(), self.rows, self.cols,
                                      name="matsum")
            return MatrixFunction(lambda x: op(fm(x), gm(x)), self.IRows(),
                                  self.rows, self.cols, name="matsum")
        if _is_numericlike(other) and not isinstance(other, VectorFunction):
            a = config.tensor(np.broadcast_to(
                np.asarray(other, np.float64), (self.rows, self.cols)).copy())
            if reverse:
                return MatrixFunction(lambda x: op(a, fm(x)), self.IRows(),
                                      self.rows, self.cols, name="matsum")
            return MatrixFunction(lambda x: op(fm(x), a), self.IRows(),
                                  self.rows, self.cols, name="matsum")
        return NotImplemented

    def __add__(self, other):
        return self._mat_add(other)

    def __radd__(self, other):
        return self._mat_add(other, reverse=True)

    def __sub__(self, other):
        return self._mat_add(other, sub=True)

    def __rsub__(self, other):
        return self._mat_add(other, sub=True, reverse=True)

    def __neg__(self):
        fm = self._fm
        return MatrixFunction(lambda x: -fm(x), self.IRows(),
                              self.rows, self.cols, name="matneg")

    # --------------------------------------------------------------- methods
    def inverse(self):
        """Closed-form inverse up to 3x3; above, an f64 LU inverse (the
        JAX package refines an f32 inverse by two Newton steps to the same
        f64 result)."""
        if self.rows != self.cols:
            raise ValueError("inverse requires a square matrix")
        n = self.rows
        if n == 1:
            inv = lambda M: 1.0 / M  # noqa: E731
        elif n == 2:
            inv = _inv2
        elif n == 3:
            inv = _inv3
        else:
            inv = torch.linalg.inv
        fm = self._fm
        return MatrixFunction(lambda x: inv(fm(x)), self.IRows(),
                              self.rows, self.cols, name="matinv")

    def transpose(self):
        fm = self._fm
        return MatrixFunction(lambda x: fm(x).transpose(0, 1), self.IRows(),
                              self.cols, self.rows, name="mattrans")

    def determinant(self):
        if self.rows != self.cols:
            raise ValueError("determinant requires a square matrix")
        fm = self._fm
        return VectorFunction(
            lambda x: torch.atleast_1d(torch.linalg.det(fm(x))),
            self.IRows(), 1, name="matdet")


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


def ColMatrix(func, rows, cols):
    """Interpret func's output as a (rows, cols) matrix stored
    column-major."""
    func = as_function(func) if not isinstance(func, VectorFunction) \
        else func
    rows, cols = int(rows), int(cols)
    if func.ORows() != rows * cols:
        raise ValueError("ColMatrix: output size != rows*cols")
    f = func._fn
    return MatrixFunction(
        lambda x: torch.atleast_1d(f(x)).reshape(cols, rows).transpose(0, 1),
        func.IRows(), rows, cols, name="ColMatrix")
