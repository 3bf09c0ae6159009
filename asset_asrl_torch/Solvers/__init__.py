"""asset_asrl_torch.Solvers: NLP assembly + the PSIOPT interior-point
solver on the block-tridiagonal KKT (or the dense KKT when a problem's
structure does not fit it)."""

from .nlp import NonLinearProgram, IndexedFunction
from .psiopt import PSIOPT, ConvergenceFlags
from .kkt_dense import DenseKKT
