"""ODE definition layer: ODEArguments / ODEBase.

Port of `asset_asrl_tpu/OptimalControl/ode.py`.  An ODE is a
VectorFunction mapping the packed input [x, t, u, p] (sizes XV, 1, UV, PV)
to dx/dt (XV).
"""

from __future__ import annotations

from ..VectorFunctions.function import Arguments

__all__ = ["ODEArguments", "ODEBase"]


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
    a collocation Phase over it."""

    def __init__(self, odefunc=None, Xvars=None, Uvars=0, Pvars=0):
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

    def phase(self, tmode, *args, **kwargs):
        from .phase import Phase
        return Phase(self, tmode, *args, **kwargs)
