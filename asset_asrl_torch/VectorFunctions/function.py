"""Core VectorFunction layer: composable differentiable torch closures.

Port of `asset_asrl_tpu/VectorFunctions/function.py`.  A VectorFunction is
a closure ``fn: tensor (IRows,) -> tensor (ORows,)``.  Composition is
closure composition; derivatives (Jacobian, adjoint gradient J^T lam,
adjoint Hessian grad^2 lam^T f) come from `torch.func` (`jacfwd`, `vjp`),
and families of applications are evaluated with `torch.func.vmap`.
Closures therefore hold no Python branch on a tensor value.

Numeric constants become float64 tensors on `config.DEVICE` when the
expression is built, so a closure never mixes devices.
"""

from __future__ import annotations

import numbers
import threading

import numpy as np
import torch
from torch.func import jacfwd, vjp

from .. import config

__all__ = [
    "VectorFunction",
    "Arguments",
    "Constant",
    "as_function",
    "stack",
]


def _is_numericlike(v):
    return isinstance(v, (numbers.Number, np.ndarray, torch.Tensor, list,
                          tuple, range))


# Trace-time common-subexpression cache.  Expression composition builds
# Python closure trees; a subexpression reused k times would be re-run k
# times per enclosing node, exponential in expression depth.  Memoizing
# each node's output per input object during one root call turns the tree
# back into the DAG the user wrote.  The cache lives only for the duration
# of the outermost node call (depth counter), so no transformed tensors
# leak across calls; cached values keep their input alive, so id() reuse
# cannot alias keys.  Thread-local, so concurrent evaluations never share
# a cache.
_TRACE_TLS = threading.local()


def _trace_state():
    st = getattr(_TRACE_TLS, "state", None)
    if st is None:
        st = {"depth": 0, "cache": None}
        _TRACE_TLS.state = st
    return st


def _memoized(node, raw):
    def wrapped(x):
        st = _trace_state()
        root = st["depth"] == 0
        if root:
            st["cache"] = {}
        st["depth"] += 1
        try:
            cache = st["cache"]
            key = (id(node), id(x))
            hit = cache.get(key)
            if hit is not None and hit[0] is x:
                return hit[1]
            out = raw(x)
            cache[key] = (x, out)
            return out
        finally:
            st["depth"] -= 1
            if root:
                st["cache"] = None
    return wrapped


def _const_array(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return config.tensor(np.asarray(v, dtype=np.float64).reshape(-1))


def as_function(v, irows=None):
    """Promote a numeric value to a Constant VectorFunction of input size
    irows."""
    if isinstance(v, VectorFunction):
        return v
    if irows is None:
        raise ValueError(
            "Cannot promote a numeric constant to a VectorFunction without "
            "knowing the input size; combine it with at least one function.")
    a = _const_array(v)
    return VectorFunction(lambda x, a=a: a, irows, int(a.shape[0]),
                          name="Constant")


def _1d(t):
    return torch.atleast_1d(t)


class VectorFunction:
    """A differentiable map R^IRows -> R^ORows built from a torch closure."""

    # numpy must defer to the reflected operators: without these,
    # `np_array - expr` broadcasts element-wise over the expression.
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, fn, irows, orows, name="VectorFunction"):
        self._fn = _memoized(self, fn)
        self._ir = int(irows)
        self._orr = int(orows)
        self._name = name

    # ------------------------------------------------------------------ sizes
    def IRows(self):
        return self._ir

    def ORows(self):
        return self._orr

    @property
    def name(self):
        return self._name

    def __repr__(self):
        return f"<{self._name}: R^{self._ir} -> R^{self._orr}>"

    # ------------------------------------------------------------- tracing
    def trace(self, x):
        """Apply the closure to a tensor of size IRows."""
        return _1d(self._fn(x))

    # ------------------------------------------------------------- numerics
    def _x(self, x):
        x = config.tensor(np.asarray(x, np.float64).reshape(-1)) \
            if not isinstance(x, torch.Tensor) else x.to(config.DTYPE)
        if x.shape[0] != self._ir:
            raise ValueError(
                f"{self!r} expected input of size {self._ir}, "
                f"got {x.shape[0]}")
        return x

    def _l(self, l):
        l = config.tensor(np.asarray(l, np.float64).reshape(-1)) \
            if not isinstance(l, torch.Tensor) else l.to(config.DTYPE)
        if l.shape[0] != self._orr:
            raise ValueError(
                f"{self!r} expected multiplier of size {self._orr}, "
                f"got {l.shape[0]}")
        return l

    def _agrad(self, l):
        def agrad(y):
            return vjp(self.trace, y)[1](l)[0]
        return agrad

    def compute(self, x):
        return self.trace(self._x(x)).cpu().numpy()

    def jacobian(self, x):
        return jacfwd(self.trace)(self._x(x)).cpu().numpy()

    def adjointgradient(self, x, l):
        return self._agrad(self._l(l))(self._x(x)).cpu().numpy()

    def adjointhessian(self, x, l):
        return jacfwd(self._agrad(self._l(l)))(self._x(x)).cpu().numpy()

    def computeall(self, x, l):
        x, l = self._x(x), self._l(l)
        agrad = self._agrad(l)
        out = (self.trace(x), jacfwd(self.trace)(x), agrad(x),
               jacfwd(agrad)(x))
        return tuple(t.cpu().numpy() for t in out)

    # ------------------------------------------------------------ composition
    def eval(self, other):
        """Composition self(other(x))."""
        other = _stack_arg(other)
        if other.ORows() != self._ir:
            raise ValueError(
                f"Cannot compose {self!r} with {other!r}: size mismatch")
        f, g = self._fn, other._fn
        return VectorFunction(lambda x: f(_1d(g(x))),
                              other.IRows(), self._orr,
                              name=f"{self._name}∘{other._name}")

    def __call__(self, *args):
        if len(args) == 1 and _is_numericlike(args[0]) \
                and not isinstance(args[0], VectorFunction):
            return self.compute(args[0])
        if len(args) == 1 and isinstance(args[0], VectorFunction):
            return self.eval(args[0])
        return self.eval(stack(list(args)))

    # ---------------------------------------------------------- sub-selection
    def coeff(self, i):
        i = int(i)
        f = self._fn
        return VectorFunction(lambda x: _1d(f(x))[i:i + 1],
                              self._ir, 1, name=f"{self._name}[{i}]")

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._orr)
            if step != 1:
                raise NotImplementedError("strided slices are not ported yet")
            return self.segment(start, stop - start)
        return self.coeff(i)

    def segment(self, start, size):
        start, size = int(start), int(size)
        if start < 0 or start + size > self._orr:
            raise ValueError(
                f"segment({start},{size}) out of range for {self!r}")
        f = self._fn
        return VectorFunction(lambda x: _1d(f(x))[start:start + size],
                              self._ir, size, name=f"{self._name}.segment")

    def head(self, size):
        return self.segment(0, size)

    def tail(self, size):
        return self.segment(self._orr - size, size)

    def tolist(self, pairs=None):
        """List of scalar element functions; with pairs, list of segments."""
        if pairs is None:
            return [self.coeff(i) for i in range(self._orr)]
        return [self.segment(s, n) for (s, n) in pairs]

    # -------------------------------------------------------------- arithmetic
    def _binary(self, other, op, opname, reverse=False):
        if _is_numericlike(other) and not isinstance(other, VectorFunction):
            a = _const_array(other)
            f = self._fn
            if reverse:
                out = np.broadcast_shapes((int(a.shape[0]),),
                                          (self._orr,))[0]
                return VectorFunction(lambda x: _1d(op(a, _1d(f(x)))),
                                      self._ir, out, name=opname)
            out = np.broadcast_shapes((self._orr,), (int(a.shape[0]),))[0]
            return VectorFunction(lambda x: _1d(op(_1d(f(x)), a)),
                                  self._ir, out, name=opname)
        if isinstance(other, VectorFunction):
            if other.IRows() != self._ir:
                raise ValueError(
                    f"Cannot combine {self!r} and {other!r}: input sizes "
                    "differ")
            out = np.broadcast_shapes((self._orr,), (other.ORows(),))[0]
            f, g = self._fn, other._fn
            if reverse:
                return VectorFunction(
                    lambda x: _1d(op(_1d(g(x)), _1d(f(x)))),
                    self._ir, out, name=opname)
            return VectorFunction(
                lambda x: _1d(op(_1d(f(x)), _1d(g(x)))),
                self._ir, out, name=opname)
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, torch.add, "add")

    def __radd__(self, other):
        return self._binary(other, torch.add, "add", reverse=True)

    def __sub__(self, other):
        return self._binary(other, torch.sub, "sub")

    def __rsub__(self, other):
        return self._binary(other, torch.sub, "sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, torch.mul, "mul")

    def __rmul__(self, other):
        return self._binary(other, torch.mul, "mul", reverse=True)

    def __truediv__(self, other):
        return self._binary(other, torch.div, "div")

    def __rtruediv__(self, other):
        return self._binary(other, torch.div, "div", reverse=True)

    def __pow__(self, p):
        if isinstance(p, VectorFunction):
            return self._binary(p, torch.pow, "pow")
        f = self._fn
        if float(p) == int(p):
            # integral exponents keep polynomial derivative rules (no
            # log(x) terms, so no NaN second derivatives at x == 0)
            ip = int(p)
            return VectorFunction(lambda x: _1d(f(x)) ** ip,
                                  self._ir, self._orr, name="pow")
        p = float(p)
        return VectorFunction(lambda x: torch.pow(_1d(f(x)), p),
                              self._ir, self._orr, name="pow")

    def __neg__(self):
        f = self._fn
        return VectorFunction(lambda x: -_1d(f(x)),
                              self._ir, self._orr, name="neg")

    # -------------------------------------------------------------- cwise map
    def cwise(self, op, name="cwise"):
        f = self._fn
        return VectorFunction(lambda x: op(_1d(f(x))),
                              self._ir, self._orr, name=name)


class Arguments(VectorFunction):
    """Identity function on R^n: the root of every expression."""

    def __init__(self, n):
        n = int(n)
        super().__init__(lambda x: x, n, n, name=f"Arguments[{n}]")


def Constant(irows, value):
    """Constant output function of given input size."""
    a = _const_array(value)
    return VectorFunction(lambda x: a, int(irows), int(a.shape[0]),
                          name="Constant")


def _stack_arg(v, irows=None):
    """Promote stack()/dot() arguments: functions pass through, lists of
    functions get stacked, numerics become constants."""
    if isinstance(v, VectorFunction):
        return v
    if isinstance(v, (list, tuple)) and any(
            isinstance(e, VectorFunction) for e in v):
        return stack(list(v))
    return as_function(v, irows=irows)


def stack(*funcs):
    """Stack outputs of functions/constants sharing one input space.
    Accepts stack([f1, f2, ...]) or stack(f1, f2, ...); numeric entries
    become constants."""
    if len(funcs) == 1 and isinstance(funcs[0], (list, tuple)):
        funcs = tuple(funcs[0])
    ir = None
    for f in funcs:
        if isinstance(f, VectorFunction):
            ir = f.IRows()
            break
    if ir is None:
        raise ValueError("stack needs at least one VectorFunction")
    parts = []
    orows = 0
    for f in funcs:
        if isinstance(f, VectorFunction):
            if f.IRows() != ir:
                raise ValueError("stack: all functions must share input size")
            parts.append(f)
        else:
            parts.append(as_function(f, irows=ir))
        orows += parts[-1].ORows()
    fns = [p._fn for p in parts]
    return VectorFunction(
        lambda x: torch.cat([_1d(fn(x)) for fn in fns]),
        ir, orows, name="stack")
