"""asset_asrl_torch.OptimalControl: the `oc` namespace (ported subset)."""

from .ode import ODEArguments, ODEBase
from .phase import Phase, PhaseRegionFlags, TranscriptionModes, ControlModes
