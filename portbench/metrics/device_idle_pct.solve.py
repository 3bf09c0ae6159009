"""device_idle_pct.solve: the share of the traced solves in which no
operation ran on the device."""

from portbench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
