"""asset_asrl_torch.Utils: core counts, timers, spans and the profiler.

Port of `asset_asrl_tpu/Utils/__init__.py`.  `Profiler` runs
`torch.profiler` instead of the JAX profiler and writes a Chrome trace;
`span` names a stretch of the solver's work in that trace, and every
collection of Python's garbage collector made while a profiler records
is a range `asset.gc.gen<generation>` in it.
"""

import gc
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


class span:
    """A named stretch of host work:

        with span("asset.fused.factor", stats, "kkt_s"):
            ...

    While a profiler records (`Profiler`, or any `torch.profiler` run) the
    block is a `record_function` range of that name, on the profiler's
    clock beside the device's activity; otherwise no range is entered (the
    check is a flag read, while a `record_function` costs ~10 us even with
    no profiler).  With `acc`, the block's host seconds
    (`time.perf_counter`) are added to `acc[key]`.  It never synchronizes
    the device, so the seconds are the host's: a block that waits on the
    device counts the wait.  Names start with `asset.`; callers build them
    once, not per call."""

    __slots__ = ("name", "acc", "key", "_range", "_t0")

    def __init__(self, name, acc=None, key=None):
        self.name, self.acc, self.key = name, acc, key

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.acc is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.acc is not None:
            self.acc[self.key] += time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_GC_RANGES = tuple(f"asset.gc.gen{g}" for g in range(3))
_gc_open = []


def _gc_range(phase, info):
    """`gc.callbacks` hook: while a profiler records, a collection is a
    range named by its generation, so that a pause of the host inside the
    solver's work is named in the trace.  A collection can start inside a
    `torch.func` transform, so the range is a `_RecordFunctionFast`,
    which dispatches no operator."""
    if phase == "start":
        if torch.autograd._profiler_enabled():
            r = torch._C._profiler._RecordFunctionFast(
                _GC_RANGES[info["generation"]])
            r.__enter__()
            _gc_open.append(r)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_gc_range)


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
