"""asset_asrl_torch: the PyTorch/CUDA port of asset_asrl_tpu.

Same namespace layout as the JAX package:

    import asset_asrl_torch as ast
    vf = ast.VectorFunctions
    oc = ast.OptimalControl

It imports torch and never jax.  Tensors are float64 on `config.DEVICE`
(CUDA when a card is present, else the CPU).
"""

from . import config  # noqa: F401
from . import VectorFunctions
from . import Solvers
from . import OptimalControl
from . import Integrators
from . import Astro

__version__ = "0.2.0"
