"""Named-variable (Vgroups), units and auto-scaling variants of the
examples (`examples/UpdatedInterface/`)."""
