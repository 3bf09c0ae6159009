"""asset_asrl_torch.Solvers: NLP assembly + the PSIOPT interior-point
solver on the block-tridiagonal KKT (sharded over a mesh by
`kkt_sharded`, or the dense KKT when a problem's structure does not fit
it), generic optimization problems and the Jet
thread-pool runner."""

from .nlp import NonLinearProgram, IndexedFunction
from .psiopt import PSIOPT, ConvergenceFlags
from .kkt_dense import DenseKKT
from .optprob import OptimizationProblem
from .jet import Jet
