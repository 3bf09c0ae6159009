"""device_idle_pct.ensemble: the share of the traced ensemble calls in
which no operation ran on the device."""

from portbench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
