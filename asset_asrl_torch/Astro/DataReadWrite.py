"""Trajectory table disk IO (reference `asset_asrl/Astro/DataReadWrite.py`).

Port of `asset_asrl_tpu/Astro/DataReadWrite.py`."""

import numpy as np


def WriteData(traj, path):
    np.savetxt(path, np.asarray([np.asarray(r).ravel() for r in traj]))


def ReadData(path):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    return [row.copy() for row in data]


WriteTraj = WriteData
ReadTraj = ReadData
