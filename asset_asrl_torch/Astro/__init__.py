"""asset_asrl_torch.Astro: the astrodynamics layer (models, frames, Kepler
propagation, Lambert, element conversions, constants), with the JAX
package's names (reference `src/Astro/` + `asset_asrl/Astro/`)."""

from . import Constants
from .Frames import TwoBodyFrame, CR3BPFrame, MEETwoBodyFrame
from .ThrusterModels import LowThrustAcc, CSIThruster, SolarSail
from .AstroModels import (TwoBody, CR3BP, TwoBody_LT, CR3BP_LT,
                          MEETwoBody_LT, MEETwoBody_CSI, Kepler,
                          TwoBody_SolarSail, CR3BP_SolarSail)
from .kepler import (KeplerPropagator, propagate_kepler, lambert_izzo,
                     lambert_izzo_batch, lambert_izzo_multi,
                     cartesian_to_classic, classic_to_cartesian,
                     cartesian_to_modified, modified_to_cartesian,
                     true_to_mean_anomaly, mean_to_true_anomaly,
                     CartesianToClassic, ClassicToCartesian,
                     CartesianToModified, ModifiedToCartesian,
                     ModifiedToClassic, ClassicToModified)
from .J2 import J2Cartesian, J2Modified
from . import Date
from . import DataReadWrite
from .DataReadWrite import ReadData, WriteData
from . import AstroConstraints
from . import FramePlot
from .FramePlot import PlotBase, CRPlot, TBPlot
