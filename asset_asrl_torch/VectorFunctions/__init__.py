"""asset_asrl_torch.VectorFunctions: the `vf` namespace.

Ported: the core functions, the free functions of `ops`, and the runtime
matrices.  Interpolation tables, root finders and Python-callback
functions are not ported yet (ROADMAP queue 1).
"""

from .function import (VectorFunction, ScalarFunction, Arguments,
                       ConditionalFunction, Constant, as_function, stack)
from .ops import (sin, cos, tan, arcsin, arccos, arctan, arctan2,
                  sinh, cosh, tanh, sqrt, cbrt, exp, log, log10,
                  abs, sign, squared, cubed, inverse,
                  sum, SumElems, dot, cross, normalize, ifelse,
                  min, max, quatProduct, quatRotate,
                  Scaled, RowScaled, IOScaled)
from .matrix import MatrixFunction, RowMatrix, ColMatrix

# ASSET alias: vf.Stack == vf.stack
Stack = stack
