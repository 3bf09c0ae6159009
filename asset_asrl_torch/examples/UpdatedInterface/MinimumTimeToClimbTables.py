"""Aero/thrust table data for MinimumTimeToClimb (identical to the
top-level `examples/MinimumTimeToClimbTables.py`; the reference ships a
verbatim copy in UpdatedInterface/)."""



from ..MinimumTimeToClimbTables import *          # noqa: F401,F403
