"""ODE definition layer: ODEArguments / ODEBase / GenericODE.

Port of `asset_asrl_tpu/OptimalControl/ode.py`.  An ODE is a
VectorFunction mapping the packed input [x, t, u, p] (sizes XV, 1, UV, PV)
to dx/dt (XV).
"""

from __future__ import annotations

import numpy as np
import torch

from ..VectorFunctions.function import Arguments, VectorFunction

__all__ = ["ODEArguments", "ODEBase", "GenericODE"]


class ODEArguments(Arguments):
    """Argument pack for writing ODE right-hand sides: [x (XV), t, u (UV),
    p (PV)]."""

    def __init__(self, XVars, UVars=0, PVars=0):
        self.XV = int(XVars)
        self.UV = int(UVars)
        self.PV = int(PVars)
        super().__init__(self.XV + 1 + self.UV + self.PV)

    def XVars(self):
        return self.XV

    def UVars(self):
        return self.UV

    def PVars(self):
        return self.PV

    def XtVars(self):
        return self.XV + 1

    def XtUVars(self):
        return self.XV + 1 + self.UV

    def XVec(self):
        return self.head(self.XV)

    def XVar(self, i):
        return self.coeff(i)

    def TVar(self):
        return self.coeff(self.XV)

    def UVec(self):
        return self.segment(self.XV + 1, self.UV)

    def UVar(self, i):
        return self.coeff(self.XV + 1 + int(i))

    def PVec(self):
        return self.segment(self.XV + 1 + self.UV, self.PV)

    def PVar(self, i):
        return self.coeff(self.XV + 1 + self.UV + int(i))


class ODEBase:
    """Base class users subclass with an ODE expression; `.phase()` builds
    a collocation Phase over it and `.integrator()` an adaptive
    Runge-Kutta Integrator."""

    def __init__(self, odefunc=None, Xvars=None, Uvars=0, Pvars=0,
                 Vgroups=None):
        if odefunc is None:
            raise ValueError("ODEBase requires an ODE expression")
        if Xvars is None:
            raise ValueError("ODEBase requires Xvars")
        self.XV = int(Xvars)
        self.UV = int(Uvars)
        self.PV = int(Pvars)
        expected = self.XV + 1 + self.UV + self.PV
        if odefunc.IRows() != expected:
            raise ValueError(
                f"ODE expression input size {odefunc.IRows()} != "
                f"XtUPVars {expected}")
        if odefunc.ORows() != self.XV:
            raise ValueError(
                f"ODE expression output size {odefunc.ORows()} != XVars "
                f"{self.XV}")
        self._vf = odefunc
        self.Vgroups = {}
        if Vgroups:
            self.add_Vgroups(Vgroups)

    def add_Vgroups(self, Vgroups):
        """Register named variable groups: values may be index lists,
        Arguments-derived segment/element functions (indices recovered by
        probing with arange), or lists of group names."""
        for names, val in Vgroups.items():
            idxs = self._make_index_set(val)
            if isinstance(names, tuple):
                for nm in names:
                    self.Vgroups[str(nm)] = idxs
            else:
                self.Vgroups[str(names)] = idxs

    def _make_index_set(self, val):
        if isinstance(val, VectorFunction):
            out = val.compute(np.arange(val.IRows(), dtype=np.float64))
            return np.rint(out).astype(np.int64)
        vals = []
        for v in np.atleast_1d(np.asarray(val, dtype=object)).ravel():
            if isinstance(v, str):
                vals.extend(self.Vgroups[v])
            else:
                vals.append(int(v))
        return np.asarray(vals, dtype=np.int64)

    def make_input(self, **kwargs):
        """Full [x, t, u, p] input row from named Vgroup values
        (`ode.make_input(h=0, v=0, m=m0, u=1)`)."""
        row = np.zeros(self.XtUPVars())
        for name, val in kwargs.items():
            row[self.Vgroups[str(name)]] = np.asarray(val, np.float64)
        return row

    def make_units(self, **kwargs):
        """Canonical-unit row per XtUP variable from named Vgroup units
        (consumed by `phase.setUnits`)."""
        units = np.ones(self.XtUPVars())
        for name, val in kwargs.items():
            units[self.Vgroups[str(name)]] = float(val) if np.isscalar(val) \
                else np.asarray(val, np.float64)
        return units

    def XVars(self):
        return self.XV

    def UVars(self):
        return self.UV

    def PVars(self):
        return self.PV

    def XtVars(self):
        return self.XV + 1

    def XtUVars(self):
        return self.XV + 1 + self.UV

    def XtUPVars(self):
        return self.XV + 1 + self.UV + self.PV

    def vf(self):
        return self._vf

    def rhs_traced(self, x, t, u, p):
        """RHS on unpacked tensor components."""
        return self._vf.trace(torch.cat([x, torch.atleast_1d(t), u, p]))

    def phase(self, tmode, *args, **kwargs):
        from .phase import Phase
        return Phase(self, tmode, *args, **kwargs)

    def integrator(self, *args, **kwargs):
        from ..Integrators import Integrator
        return Integrator(self, *args, **kwargs)


class GenericODE(ODEBase):
    """ODE from any VectorFunction RHS."""


class _OdeModule:
    """The pre-instantiated ODE modules of older scripts
    (`oc.ode_x_u.ode(func, xv, uv)`)."""

    class ode(ODEBase):
        def __init__(self, odefunc, Xvars, Uvars=0, Pvars=0):
            super().__init__(odefunc, Xvars, Uvars, Pvars)


ode_x = _OdeModule
ode_x_u = _OdeModule
ode_x_u_p = _OdeModule
