"""asset_asrl_torch.Solvers: NLP assembly + the PSIOPT interior-point
solver on the block-tridiagonal KKT."""

from .nlp import NonLinearProgram, IndexedFunction
from .psiopt import PSIOPT, ConvergenceFlags
