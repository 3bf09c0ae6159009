"""The traced run's instruments: spans around the calls into each layer,
the K1 shape log, and the reduction of a `torch.profiler` trace to device
busy time, K1's device time, the busiest device operations and the
longest idle gaps.

Spans are `torch.profiler.record_function` ranges that the benchmark puts
around the port's functions (the port has no spans of its own yet):

    portbench.family_ad    BlockKKT._eval_core
    portbench.assembly     BlockKKT._blocks_impl
    portbench.bcr_factor   kkt_block.bcr_factor
    portbench.bcr_solve    kkt_block.bcr_solve
    portbench.k1           kkt_block._inv_sym, K1's entry
    portbench.value_pass   NonLinearProgram.eval_obj_cons_impl

`Spans` installs them and takes them out again; they are installed in
traced runs only.
"""

import bisect
import contextlib
import json
import os
import re
import tempfile
import time

import torch

from portbench.roofline import k1_bound

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# K1's kernels (csrc/gj_inverse.cu, gj_inverse_wide.cu), whatever launched
K1_KERNEL = re.compile(r"\bgj_\w+_kernel\b")


def _span(name, fn):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


class Spans:
    """Spans around the port's layers while installed; `k1` logs the
    (blocks, width) of every `_inv_sym` call made while `logging`."""

    def __init__(self):
        self.k1 = []
        self.logging = False
        self._undo = []

    def install(self):
        from asset_asrl_torch.Solvers import kkt_block, nlp
        plain = kkt_block._inv_sym

        def inv_sym(D):
            if self.logging:
                self.k1.append((D.numel() // (D.shape[-1] ** 2),
                                D.shape[-1]))
            with torch.profiler.record_function("portbench.k1"):
                return plain(D)
        B, N = kkt_block.BlockKKT, nlp.NonLinearProgram
        for owner, attr, new in (
                (kkt_block, "_inv_sym", inv_sym),
                (kkt_block, "bcr_factor",
                 _span("portbench.bcr_factor", kkt_block.bcr_factor)),
                (kkt_block, "bcr_solve",
                 _span("portbench.bcr_solve", kkt_block.bcr_solve)),
                (B, "_eval_core", _span("portbench.family_ad",
                                        B._eval_core)),
                (B, "_blocks_impl", _span("portbench.assembly",
                                          B._blocks_impl)),
                (N, "eval_obj_cons_impl",
                 _span("portbench.value_pass", N.eval_obj_cons_impl))):
            self._undo.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, new)
        return self

    def remove(self):
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo = []


@contextlib.contextmanager
def profiled(device, host):
    """A `torch.profiler` run over the block: device activity only (the
    host runs at its own speed, so the idle share is the run's), or with
    `host` the host's operations and spans too (which slows the host, so
    its gaps are longer than the run's).  Yields a dict that holds, once
    the block has ended, the trace's events and the block's length on the
    host clock (both ends synchronized).  The trace goes through a file in
    TMPDIR, which is deleted."""
    acts = [torch.profiler.ProfilerActivity.CPU] if host or device != \
        "cuda" else []
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {}
    prof = torch.profiler.profile(activities=acts)
    if device == "cuda":
        torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function("portbench.stretch"):
            yield out
            if device == "cuda":
                torch.cuda.synchronize()
        out["window_s"] = time.perf_counter() - t0
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _complete(events):
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device(events, window_s):
    """From a device-only stretch: busy_s, the union of its device
    operations; window_s, its length on the host clock; device_ops, the
    10 device operations that took most time, by name."""
    dev = [e for e in _complete(events) if e.get("cat") in DEVICE_CATS]
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=sum(e - s for s, e in busy) * 1e-6,
                window_s=float(window_s),
                device_ops=[[n[:160], d * 1e-6] for n, d in ops])


def host(events, k1_shapes):
    """From a stretch traced with the host:

    k1_s         device time of every operation launched inside a
                 `portbench.k1` span (by its launch's correlation), and
                 k1_bound_s the bound of every `_inv_sym` call logged
                 (None without such calls)
    idle_gaps    the 10 longest idle gaps of the device inside the
                 stretch, each named by the innermost benchmark span and
                 host operation running at its middle
    """
    ev = _complete(events)
    stretch = [e for e in ev if e.get("name") == "portbench.stretch"]
    t0 = float(stretch[0]["ts"])
    t1 = t0 + float(stretch[0]["dur"])
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    busy = _union([(max(float(e["ts"]), t0),
                    min(float(e["ts"]) + float(e["dur"]), t1)) for e in dev
                   if float(e["ts"]) < t1
                   and float(e["ts"]) + float(e["dur"]) > t0])

    # operations launched inside a K1 span: by the launch's correlation
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ev if e.get("name") == "portbench.k1")
    starts = [s for s, _ in spans]
    inside = set()
    for e in ev:
        if e.get("cat") in LAUNCH_CATS:
            ts = float(e["ts"])
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= spans[i][1]:
                inside.add(e.get("args", {}).get("correlation"))
    k1_us = sum(float(e["dur"]) for e in dev
                if e.get("args", {}).get("correlation") in inside
                or K1_KERNEL.search(e.get("name", "")))

    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    running = [e for e in ev if e.get("cat") in ("cpu_op", "user_annotation")
               and e.get("name") != "portbench.stretch"]

    def during(start, length):
        """'<innermost portbench span> / <innermost host operation>'
        running at the gap's middle."""
        mid = start + length / 2.0
        best = {True: None, False: None}
        for e in running:
            s, d = float(e["ts"]), float(e["dur"])
            ours = e["name"].startswith("portbench.")
            if s <= mid <= s + d and (best[ours] is None
                                      or d < best[ours][0]):
                best[ours] = (d, e["name"])
        return " / ".join(b[1] if b else "-" for b in (best[True],
                                                       best[False]))

    bound = sum(k1_bound(K, W)[0] for K, W in k1_shapes)
    return dict(k1_s=k1_us * 1e-6 if spans else None,
                k1_bound_s=bound if k1_shapes else None,
                idle_gaps=[[during(s, g)[:160], g * 1e-6] for g, s in gaps])
