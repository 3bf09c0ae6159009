"""asset_asrl_torch.Integrators: adaptive Runge-Kutta integrators."""

from .rk import Integrator, RKCoeffs
