"""Free functions of the vf namespace (cwise ops, reductions, ifelse,
min/max, quaternions, scaling wrappers).

Port of `asset_asrl_tpu/VectorFunctions/ops.py`.  Each closure evaluates
the same formula as its JAX counterpart; `ifelse` evaluates both branches
and selects with `torch.where`, as `jnp.where` does, so derivatives of
the branch not taken (NaN or infinite ones included) propagate the same
way.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from .. import config
from .function import (VectorFunction, ConditionalFunction, _1d, _cross,
                       _stack_arg, as_function)

__all__ = [
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2",
    "sinh", "cosh", "tanh", "sqrt", "cbrt", "exp", "log", "log10",
    "abs", "sign", "squared", "cubed", "inverse",
    "sum", "SumElems", "dot", "cross", "normalize", "ifelse",
    "min", "max", "doublecross", "quatProduct", "quatRotate",
    "Scaled", "RowScaled", "IOScaled",
]


def _cwise(op, name):
    def apply(f):
        return _stack_arg(f).cwise(op, name=name)
    apply.__name__ = name
    return apply


def _cbrt(v):
    return torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)


sin = _cwise(torch.sin, "sin")
cos = _cwise(torch.cos, "cos")
tan = _cwise(torch.tan, "tan")
arcsin = _cwise(torch.asin, "arcsin")
arccos = _cwise(torch.acos, "arccos")
arctan = _cwise(torch.atan, "arctan")
sinh = _cwise(torch.sinh, "sinh")
cosh = _cwise(torch.cosh, "cosh")
tanh = _cwise(torch.tanh, "tanh")
sqrt = _cwise(torch.sqrt, "sqrt")
cbrt = _cwise(_cbrt, "cbrt")
exp = _cwise(torch.exp, "exp")
log = _cwise(torch.log, "log")
log10 = _cwise(torch.log10, "log10")
sign = _cwise(torch.sign, "sign")
squared = _cwise(torch.square, "squared")
cubed = _cwise(lambda v: v * v * v, "cubed")
inverse = _cwise(lambda v: 1.0 / v, "inverse")


def abs(f):  # noqa: A001 - mirrors vf.abs
    if isinstance(f, VectorFunction):
        return f.__abs__()
    return builtins.abs(f)


def _promote(a, b):
    """(a, b) as VectorFunctions; a numeric `a` takes b's input size."""
    if isinstance(a, VectorFunction) or (
            isinstance(a, (list, tuple))
            and builtins.any(isinstance(e, VectorFunction) for e in a)):
        return _stack_arg(a), b
    b = _stack_arg(b)
    return as_function(a, irows=b.IRows()), b


def arctan2(y, x):
    """Two-argument arctangent of scalar functions."""
    y = _stack_arg(y)
    x = _stack_arg(x, irows=y.IRows())
    if y.ORows() != 1 or x.ORows() != 1:
        raise ValueError("arctan2 requires scalar functions")
    fy, fx = y._fn, x._fn
    return VectorFunction(lambda v: torch.atan2(_1d(fy(v)), _1d(fx(v))),
                          y.IRows(), 1, name="arctan2")


def sum(*funcs):  # noqa: A001 - mirrors vf.sum
    """Sum of several functions/constants; with one vector function, the
    sum of its elements (SumElems)."""
    if len(funcs) == 1 and isinstance(funcs[0], (list, tuple)):
        funcs = tuple(funcs[0])
    if len(funcs) == 1 and isinstance(funcs[0], VectorFunction):
        return funcs[0].sum()
    ir = next((f.IRows() for f in funcs if isinstance(f, VectorFunction)),
              None)
    if ir is None:
        raise ValueError("vf.sum needs at least one VectorFunction")
    out = None
    for f in funcs:
        f = f if isinstance(f, VectorFunction) else as_function(f, irows=ir)
        out = f if out is None else out + f
    return out


def SumElems(f):
    return _stack_arg(f).sum()


def dot(a, b):
    a, b = _promote(a, b)
    return a.dot(b)


def cross(a, b):
    a, b = _promote(a, b)
    return a.cross(b)


def doublecross(a, b, c):
    return cross(a, b).cross(c)


def normalize(f):
    return _stack_arg(f).normalized()


def ifelse(cond, tfunc, ffunc):
    """Conditional function: both branches evaluated, selected with
    torch.where (derivatives follow the selected branch)."""
    if not isinstance(cond, ConditionalFunction):
        raise TypeError("ifelse: first argument must be a comparison "
                        "(e.g. Args(2)[0] < 1.0)")
    ir = cond.IRows()
    tfunc = tfunc if isinstance(tfunc, VectorFunction) \
        else as_function(tfunc, irows=ir)
    ffunc = ffunc if isinstance(ffunc, VectorFunction) \
        else as_function(ffunc, irows=ir)
    if tfunc.IRows() != ir or ffunc.IRows() != ir:
        raise ValueError("ifelse: input sizes must match the condition's")
    orows = int(np.broadcast_shapes((tfunc.ORows(),), (ffunc.ORows(),))[0])
    c, tf, ff = cond._fn, tfunc._fn, ffunc._fn
    return VectorFunction(
        lambda x: torch.where(c(x), _1d(tf(x)), _1d(ff(x))),
        ir, orows, name="ifelse")


def _comparative(op, name):
    def apply(a, b):
        a, b = _promote(a, b)
        return a._binary(b, op, name)
    apply.__name__ = name
    return apply


min = _comparative(torch.minimum, "min")  # noqa: A001
max = _comparative(torch.maximum, "max")  # noqa: A001


def quatProduct(q1, q2):
    """Hamilton product of two quaternions stored [x, y, z, w]."""
    q1 = _stack_arg(q1)
    q2 = _stack_arg(q2, irows=q1.IRows())
    f1, f2 = q1._fn, q2._fn

    def impl(x):
        a, b = _1d(f1(x)), _1d(f2(x))
        av, aw = a[:3], a[3]
        bv, bw = b[:3], b[3]
        v = aw * bv + bw * av + _cross(av, bv)
        w = aw * bw - torch.sum(av * bv)
        return torch.cat([v, w[None]])
    return VectorFunction(impl, q1.IRows(), 4, name="quatProduct")


def quatRotate(q, v):
    """Rotate 3-vector v by quaternion q = [x, y, z, w]."""
    q = _stack_arg(q)
    v = _stack_arg(v, irows=q.IRows())
    fq, fv = q._fn, v._fn

    def impl(x):
        qq, vv = _1d(fq(x)), _1d(fv(x))
        qv, qw = qq[:3], qq[3]
        t = 2.0 * _cross(qv, vv)
        return vv + qw * t + _cross(qv, t)
    return VectorFunction(impl, q.IRows(), 3, name="quatRotate")


def Scaled(func, value):
    """Scalar multiple of a function: value * f(x)."""
    func = as_function(func)
    value = float(value)
    fn = func._fn
    return VectorFunction(lambda x: value * _1d(fn(x)),
                          func.IRows(), func.ORows(), name="Scaled")


def RowScaled(func, row_scales):
    """Per-output-row scaling: diag(row_scales) @ f(x)."""
    func = as_function(func)
    rs = np.asarray(row_scales, np.float64).ravel()
    if rs.shape[0] != func.ORows():
        raise ValueError(
            f"RowScaled: {rs.shape[0]} scales for {func.ORows()} outputs")
    rst = config.tensor(rs)
    fn = func._fn
    return VectorFunction(lambda x: rst * _1d(fn(x)),
                          func.IRows(), func.ORows(), name="RowScaled")


def IOScaled(func, input_scales, output_scales):
    """Unit-scaling wrapper g(x) = out_scales * f(in_scales * x)."""
    func = as_function(func)
    ins = np.asarray(input_scales, np.float64).ravel()
    outs = np.asarray(output_scales, np.float64).ravel()
    if ins.shape[0] != func.IRows():
        raise ValueError(
            f"IOScaled: {ins.shape[0]} input scales for {func.IRows()} "
            "inputs")
    if outs.shape[0] != func.ORows():
        raise ValueError(
            f"IOScaled: {outs.shape[0]} output scales for {func.ORows()} "
            "outputs")
    inst, outst = config.tensor(ins), config.tensor(outs)
    fn = func._fn
    return VectorFunction(lambda x: outst * _1d(fn(inst * x)),
                          func.IRows(), func.ORows(), name="IOScaled")
