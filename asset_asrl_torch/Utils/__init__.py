"""asset_asrl_torch.Utils: core counts, timers and the profiler.

Port of `asset_asrl_tpu/Utils/__init__.py`.  `Profiler` runs
`torch.profiler` instead of the JAX profiler and writes a Chrome trace.
"""

import os
import tempfile
import time

import torch

from .. import config


def get_core_count():
    return os.cpu_count() or 1


class Timer:
    """Accumulating wall-clock timer (start/stop/count/reset)."""

    def __init__(self):
        self._t0 = None
        self._acc = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._acc += time.perf_counter() - self._t0
            self._t0 = None

    def count(self):
        return self._acc

    def reset(self):
        self._acc = 0.0
        self._t0 = None


class Profiler:
    """`torch.profiler` around a block of work:

        with ast.Utils.Profiler("traces") as prof:
            phase.optimize()
        prof.trace_path, prof.elapsed

    It records the CPU's activities, and the card's when `config.DEVICE`
    is CUDA.  On exit it writes a Chrome trace (`chrome://tracing`,
    Perfetto) into `logdir` and keeps the profile (`.profile`, whose
    `key_averages()` sums the time by kernel).  `.elapsed` is the block's
    wall-clock seconds; it is set on exit also when writing the trace
    fails.  The default `logdir` lies in the temporary directory."""

    def __init__(self, logdir=None):
        self.logdir = str(logdir) if logdir is not None else os.path.join(
            tempfile.gettempdir(), "asset_trace")
        self.elapsed = None
        self.trace_path = None
        self.profile = None
        self._t0 = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if config.DEVICE.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=acts)
        self._t0 = time.perf_counter()
        self.profile.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if config.DEVICE.type == "cuda":
                torch.cuda.synchronize()
            self.profile.__exit__(*exc)
            os.makedirs(self.logdir, exist_ok=True)
            path = os.path.join(self.logdir, f"trace_{os.getpid()}_"
                                f"{time.time_ns()}.json")
            self.profile.export_chrome_trace(path)
            self.trace_path = path
        finally:
            self.elapsed = time.perf_counter() - self._t0
        return False
