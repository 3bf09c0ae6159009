"""Astro frame extensions (reference `asset_asrl/Astro/Extensions/`)."""

from ..Frames import TwoBodyFrame, CR3BPFrame, MEETwoBodyFrame
from .NBodyFrame import NBodyFrame, KeplerianEphemeris
from .EPPRFrame import EPPRFrame
from ..ThrusterModels import LowThrustAcc, CSIThruster, SolarSail

__all__ = ["TwoBodyFrame", "CR3BPFrame", "MEETwoBodyFrame", "NBodyFrame",
           "EPPRFrame", "KeplerianEphemeris", "LowThrustAcc", "CSIThruster",
           "SolarSail"]
