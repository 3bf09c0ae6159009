"""Physical constants (reference `asset_asrl/Astro/Constants.py` surface;
values are standard published constants, km^3/s^2 for mu, meters for radii
converted as noted).  Units: mu [km^3/s^2] -> here m^3/s^2 like the
reference (SI).

Port of `asset_asrl_tpu/Astro/Constants.py`.
"""

import numpy as np

# gravitational parameters, m^3/s^2
MuSun = 1.32712440018e20
MuMercury = 2.2032e13
MuVenus = 3.24859e14
MuEarth = 3.986004418e14
MuMoon = 4.9048695e12
MuMars = 4.282837e13
MuJupiter = 1.26686534e17
MuSaturn = 3.7931187e16
MuUranus = 5.793939e15
MuNeptune = 6.836529e15
MuPluto = 8.71e11

# distances, m
AU = 1.495978707e11
LD = 3.844e8               # lunar distance

# radii, m
RadiusSun = 6.957e8
RadiusEarth = 6.371e6
RadiusMoon = 1.7374e6
RadiusMars = 3.3895e6
RadiusJupiter = 6.9911e7

# Earth J2
J2Earth = 1.08262668e-3

# time
day = 86400.0
year = 365.25 * day

# solar constants
SolarFlux = 1361.0          # W/m^2 at 1 AU
LightSpeed = 299792458.0    # m/s
SolarPressure = SolarFlux / LightSpeed  # N/m^2 at 1 AU

g0 = 9.80665                # m/s^2


def mustar(mu1, mu2):
    """CR3BP mass parameter."""
    return mu2 / (mu1 + mu2)
