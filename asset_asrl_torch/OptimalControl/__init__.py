"""asset_asrl_torch.OptimalControl: the `oc` namespace (ODEs, phases with
adaptive meshes and auto-scaling, multi-phase problems, trajectory
interpolation tables)."""

from .ode import ODEArguments, ODEBase, GenericODE, ode_x, ode_x_u, ode_x_u_p
from .phase import Phase, PhaseRegionFlags, TranscriptionModes, ControlModes
from .ocp import OptimalControlProblem, LinkFlags
from .interp_table import (LGLInterpTable, InterpFunction,
                           InterpFunction_1, InterpFunction_3,
                           InterpFunction_6)
from .fdtable import FiniteDiffTable, FDiffData
