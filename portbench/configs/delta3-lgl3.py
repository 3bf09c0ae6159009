"""delta3-lgl3: the Delta III launch to a geostationary transfer orbit of
ASSET's documentation (`doc/examples/Delta3.rst`, upstream's
`examples/Delta3Launch.py`), the launch problem of Betts, "Practical
Methods for Optimal Control and Estimation Using Nonlinear Programming",
2nd ed., SIAM 2010, section 6.15: four burn phases (six solid boosters
with the first stage, the other three with it, the first stage alone, the
second stage) in one `OptimalControlProblem`, joined by forward links,
with the largest final mass as the objective and the five slow orbital
elements fixed at burnout.  The solve's feasibility tolerances are 1e-8,
tighter than the example's defaults (ASSUMED).

`build(ast, cfg)` poses it by the port's copy of that example
(`examples/Delta3Launch.py`, `build_ocp`, reached through `ast`, the
`asset_asrl_torch` namespace passed in, so that this file imports no part
of the program) at cfg's mesh, line searches and tolerances.  CONFIG
states the example's numbers for `reference/delta3-lgl3.py`, its plain
reference; the initial guess is the example's (a straight line in
position and velocity from the launch site to the target orbit at true
anomaly -0.05, the mass linear in each phase, the control (0, 1, 0)).
"""

import importlib
import math

SOURCE = "https://github.com/AlabamaASRL/asset_asrl/blob/master/doc/examples/Delta3.rst"

CONFIG = {
    # canonical units: length (m), time (s), mass (kg)
    "Lstar": 6378145.0,
    "Tstar": 961.0,
    "Mstar": 301454.0,
    "g0": 9.80665,            # m/s^2, the Isp's reference gravity
    "mu": 3.986012e14,        # m^3/s^2
    "Re": 6378145.0,          # m, the Earth's radius
    "We": 7.29211585e-5,      # rad/s, the Earth's rotation
    "rho0": 1.225,            # kg/m^3, the air's density at the surface
    "h_scale": 7200.0,        # m, the atmosphere's scale height
    "CD": 0.5,
    "S": 4.0 * math.pi,       # m^2, the reference area
    # one solid booster, the first stage, the second stage: thrust (N),
    # specific impulse (s), burn time (s), total and propellant mass (kg)
    "T_solid": 628500.0, "T_first": 1083100.0, "T_second": 110094.0,
    "Isp_solid": 283.33364, "Isp_first": 301.68, "Isp_second": 467.21,
    "t_solid": 75.2, "t_first": 261.0, "t_second": 700.0,
    "m_solid": 19290.0, "m_first": 104380.0, "m_second": 19300.0,
    "mp_solid": 17010.0, "mp_first": 95550.0, "mp_second": 16820.0,
    "m_payload": 4164.0,
    # the target orbit at burnout: a (m), e, i, RAAN, argument of perigee
    # (degrees); the launch site's latitude is the inclination
    "a_target": 24361140.0,
    "e_target": 0.7308,
    "i_target_deg": 28.5,
    "raan_target_deg": 269.8,
    "argp_target_deg": 130.5,
    "u_norm_bounds": [0.5, 1.5],  # the control's norm (its direction
                                  # sets the thrust's)
    "r_min_first_phase": 0.999999,  # x Re: the launch site sits on Re
    "transcription": "LGL3",
    "control_mode": "HighestOrderSpline",
    "nsegs": 40,              # segments a phase: 164 nodes in all
    "ls_mode": "L1",          # the line search of both passes
    "MaxLSIters": 2,
    # PSIOPT's tolerances: KKT (stationarity) and barrier
    # (complementarity) at their defaults; equality and inequality
    # feasibility tightened from the default 1e-6 (ASSUMED)
    "tolerances": {"KKTtol": 1.0e-6, "EContol": 1.0e-8, "IContol": 1.0e-8,
                   "Bartol": 1.0e-6},
}

# keys changed from the source: the tolerances (tightened, not cut); the
# published mesh fits one card many times over, so no scale is cut
REDUCED = ["tolerances"]

# the keys of CONFIG a CPU test changes: a mesh the CPU solves in seconds
TEST_OVERRIDES = {"nsegs": 4}

ASSUMED = {
    "traffic": "each solve starts from the published guess times (1 + "
               "1e-3 N(0, 1)) on every variable: a designer's re-solve "
               "of the published ascent from a varied guess",
    "tolerances": "EContol and IContol 1e-8 where the published example "
                  "keeps PSIOPT's default 1e-6, as upstream's own examples "
                  "tighten EContol (Heteroclinic's OCP and BettsLowThrust "
                  "1e-9): at 1e-6 a sound answer's constraint violation "
                  "reaches that of the answer rounded to float32, so no "
                  "comparison could tell the two apart",
}


def build(ast, cfg):
    """The transcribed OptimalControlProblem of the four phases: the
    example's, at cfg's mesh, line searches and tolerances."""
    if (cfg["transcription"], cfg["control_mode"]) != ("LGL3",
                                                      "HighestOrderSpline"):
        raise ValueError("the example poses LGL3 phases with "
                         "HighestOrderSpline controls")
    example = importlib.import_module(ast.__name__
                                      + ".examples.Delta3Launch")
    ocp = example.build_ocp(cfg["nsegs"])
    opt = ocp.optimizer
    opt.set_OptLSMode(cfg["ls_mode"])
    opt.set_SoeLSMode(cfg["ls_mode"])
    opt.set_MaxLSIters(cfg["MaxLSIters"])
    opt.set_tols(**cfg["tolerances"])
    ocp.transcribe()
    return ocp
