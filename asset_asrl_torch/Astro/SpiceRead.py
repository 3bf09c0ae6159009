"""SPICE ephemeris reading (reference `asset_asrl/Astro/SpiceRead.py`).

The reference shells out to spiceypy; these helpers gate on its
availability and raise with guidance when it is not installed.
The downstream consumer (LGLInterpTable over ephemeris states) works with
any (N, 7) state/time table regardless of source.

Port of `asset_asrl_tpu/Astro/SpiceRead.py`.
"""

import numpy as np


def _spice():
    try:
        import spiceypy
        return spiceypy
    except ImportError as e:
        raise ImportError(
            "SpiceRead requires spiceypy; supply precomputed ephemeris "
            "tables to LGLInterpTable instead") from e


def GetEphemTraj(body, startJD, endJD, numstates, frame="J2000",
                 observer="SOLAR SYSTEM BARYCENTER",
                 lstar=1.0, tstar=1.0):
    """Sample body states from loaded SPICE kernels into [r, v, t] rows."""
    sp = _spice()
    from .Date import jd_to_j2000s
    ets = np.linspace(jd_to_j2000s(startJD), jd_to_j2000s(endJD),
                      int(numstates))
    rows = []
    for et in ets:
        st, _ = sp.spkezr(body, et, frame, "NONE", observer)
        r = np.asarray(st[:3]) * 1000.0 / lstar
        v = np.asarray(st[3:6]) * 1000.0 / (lstar / tstar)
        rows.append(np.concatenate([r, v, [et / tstar]]))
    return rows
