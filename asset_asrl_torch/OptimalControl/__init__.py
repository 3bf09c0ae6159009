"""asset_asrl_torch.OptimalControl: the `oc` namespace (ported subset:
ODEs, phases and multi-phase problems)."""

from .ode import ODEArguments, ODEBase
from .phase import Phase, PhaseRegionFlags, TranscriptionModes, ControlModes
from .ocp import OptimalControlProblem, LinkFlags
