"""asset_asrl_torch.VectorFunctions: the `vf` namespace (ported subset)."""

from .function import VectorFunction, Arguments, Constant, as_function, stack
from .ops import sin, cos
from .matrix import MatrixFunction, RowMatrix

# ASSET alias: vf.Stack == vf.stack
Stack = stack
