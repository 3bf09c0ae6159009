"""asset_asrl_torch.VectorFunctions: the `vf` namespace.

The core functions, the free functions of `ops`, the runtime matrices,
interpolation tables, root finders and Python-callback functions, as the
JAX package's namespace exports them.
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
from .pyfunc import PyVectorFunction, PyScalarFunction

# ASSET alias: vf.Stack == vf.stack
Stack = stack
from .interp import InterpTable1D, InterpTable2D, InterpTable3D, InterpTable4D
from .rootfinder import ScalarRootFinder, RootFinder
