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
from . import Utils
from . import parallel  # noqa: F401
from . import distributed  # noqa: F401 -- process groups + meshes

__version__ = "0.2.0"


def SoftwareInfo():
    """Start-up banner: the version, torch's and the devices."""
    import torch
    if torch.cuda.is_available():
        devs = ", ".join(f"cuda:{i} {torch.cuda.get_device_name(i)}"
                         for i in range(torch.cuda.device_count()))
    else:
        devs = "cpu"
    print(f"asset_asrl_torch {__version__}: the PyTorch/CUDA port of ASSET "
          f"(torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"devices: {devs}; problems on {config.DEVICE})")
