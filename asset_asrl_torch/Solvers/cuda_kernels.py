"""Hand-written CUDA kernels of the block-KKT hot path, with their plain
PyTorch versions.

K1: batched unpivoted Gauss-Jordan inverse + pivot sequence + inertia
epilogue, for any block width.  Blocks up to `MAX_W` wide go through the
narrow kernels (`csrc/gj_inverse.cu`: one warp a block with the rows in
registers up to 32, two warps a block up to 64), wider ones (the dense
border of a multi-phase KKT) through the wide kernel
(`csrc/gj_inverse_wide.cu`: a blocked elimination in panels of `NB`
columns spread over all SMs).  They replace the Pallas kernel
`asset_asrl_tpu/Solvers/pallas_kernels.py: batched_gj_inverse` and, on the
f64 main path, the XLA loop `kkt_block._inv_gj_pivots`.

`gj_inverse(D)` returns `(Dinv, pivs)`; `gj_inverse_inertia(D)` returns
`(Dinv, pivs, nbad)`, with the count of bad pivots per block and 0 stored
for every non-finite entry of the inverse, computed inside the kernel.

The sources are compiled at first use with `nvcc` (sm_90a), one process a
library, all started together, into shared libraries with a plain C interface,
keyed by a hash of the sources, under `asset_asrl_torch/_build/`, and
loaded with ctypes.  A CUDA tensor always goes through a kernel or raises;
a CPU tensor takes the plain PyTorch version (the tests run on the CPU):
`gj_inverse_ref`, the unblocked elimination, whatever the width.
`gj_inverse_blocked_ref` repeats the wide kernel's panel algorithm step
for step, so that its arithmetic can be tested without a card.
`gj_inverse.launches` counts calls that launched a narrow kernel,
`gj_inverse.wide_launches` those that launched the wide one, and
`gj_inverse.shapes` every launch by its (K, W).  Launches made while a
CUDA graph is warmed up and captured are left out (`uncounted`), and each
replay of the graph counts the launches it replays (`count_replayed`),
also in `gj_inverse.replayed` by (K, W): the launches that no host call
shows.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
# (library, source)
_TARGETS = (("narrow", "gj_inverse.cu"), ("wide", "gj_inverse_wide.cu"))
_BUILD = os.path.join(_PKG, "_build")
MAX_W = 64          # widest block of the narrow kernels
NB = 32             # panel width of the wide kernel
_GUARD = {torch.float64: 1e-300, torch.float32: 1e-30}
_TINY = {torch.float64: 1e-250, torch.float32: 1e-25}
_libs = None


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return path


def build():
    """Compile (once per hash of the sources) and load the kernel
    libraries, one `nvcc` a library, all started together.  Returns the
    ctypes libraries by name: "narrow" and "wide".
    What `ptxas -v` printed for each (registers, spills, shared memory of
    every kernel) is kept beside the library as `<library>.ptxas.txt`;
    `build.logs` lists those files."""
    global _libs
    if _libs is not None:
        return _libs
    h = hashlib.sha256()
    for name in sorted(os.listdir(_CSRC)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    sos = {lib: os.path.join(_BUILD, f"libgj_{lib}_{tag}.so")
           for lib, _ in _TARGETS}
    jobs = []
    for lib, source in _TARGETS:
        so = sos[lib]
        if os.path.exists(so):
            continue
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
               "-fPIC", "-o", tmp, os.path.join(_CSRC, source)]
        jobs.append((so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    for so, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {so}:\n{log}")
        with open(f"{so}.ptxas.txt", "w") as f:
            f.write(log)
        os.replace(tmp, so)
    libs = {lib: ctypes.CDLL(so) for lib, so in sos.items()}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib, name, argtypes in (
            ("narrow", "gj_inverse_f64", [ptr] * 4 + [i64, i32, i32, ptr]),
            ("narrow", "gj_inverse_f32", [ptr] * 4 + [i64, i32, i32, ptr]),
            ("wide", "gj_inverse_wide_f64", [ptr] * 5 + [i64, i32, i32, ptr]),
            ("wide", "gj_inverse_wide_f32", [ptr] * 5 + [i64, i32, i32, ptr])):
        fn = getattr(libs[lib], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build.logs = [f"{so}.ptxas.txt" for so in sos.values()]
    _libs = libs
    return _libs


build.logs = []


def gj_inverse_ref(D):
    """Plain PyTorch batched unpivoted Gauss-Jordan on the augmented
    [D | I], op for op as `kkt_block._inv_gj_pivots`.  D: (K, W, W) f64 or
    f32.  Returns (Dinv, pivs) in D's dtype; pivs[:, j] is the diagonal
    entry before step j (its sign gives the inertia)."""
    K, W, _ = D.shape
    guard = _GUARD[D.dtype]
    eye = torch.eye(W, dtype=D.dtype, device=D.device).expand(K, W, W)
    M = torch.cat([D, eye], dim=2)
    pivs = torch.zeros((K, W), dtype=D.dtype, device=D.device)
    one = torch.ones((), dtype=D.dtype, device=D.device)
    for j in range(W):
        dj = M[:, j, j]
        pivs[:, j] = dj
        dsafe = torch.where(dj.abs() > guard, dj, one)
        piv = M[:, j, :] / dsafe[:, None]
        M = M - M[:, :, j][:, :, None] * piv[:, None, :]
        M[:, j, :] = piv
    return M[:, :, W:].contiguous(), pivs


def gj_inverse_blocked_ref(D, nb=NB):
    """Plain PyTorch version of the wide kernel's algorithm: the blocked
    right-looking Gauss-Jordan in panels of `nb` columns, step for step.
    For panel J of the current state A: inv(A_JJ) by the unblocked
    elimination (its pivots are the pivots of the unblocked elimination of
    the whole block, summed in another order), then
    A_Jc <- inv(A_JJ) A_Jc, A_ic <- A_ic - A_iJ A_Jc, A_iJ <- -A_iJ
    inv(A_JJ), A_JJ <- inv(A_JJ) for i, c outside J.  Returns (Dinv,
    pivs) as `gj_inverse_ref` does."""
    K, W, _ = D.shape
    A = D.clone()
    pivs = torch.zeros((K, W), dtype=D.dtype, device=D.device)
    idx = torch.arange(W, device=D.device)
    for j0 in range(0, W, nb):
        j1 = min(W, j0 + nb)
        rest = torch.cat([idx[:j0], idx[j1:]])
        Pinv, pivs[:, j0:j1] = gj_inverse_ref(A[:, j0:j1, j0:j1])
        R = Pinv @ A[:, j0:j1, rest]
        cold = A[:, rest, j0:j1]
        A[:, rest[:, None], rest[None, :]] -= cold @ R
        A[:, j0:j1, rest] = R
        A[:, rest, j0:j1] = -(cold @ Pinv)
        A[:, j0:j1, j0:j1] = Pinv
    return A, pivs


def _check(D, who):
    if D.ndim != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"{who}: expected (K, W, W), got {tuple(D.shape)}")
    if D.dtype not in _GUARD:
        raise ValueError(f"{who}: dtype {D.dtype} not supported "
                         "(float64 or float32)")
    if D.shape[1] < 1:
        raise ValueError(f"{who}: block width {D.shape[1]} < 1")
    if D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {D.device}")


def _launch(D, sanitize, who):
    """Launch K1 on the CUDA tensor D on the current stream: the narrow
    kernel for W <= MAX_W, the wide kernel above.  Returns (Dinv, pivs,
    nbad)."""
    if not D.is_contiguous():
        raise ValueError(f"{who}: input must be contiguous")
    K, W, _ = D.shape
    wide = W > MAX_W
    if wide and K > 65535:
        raise ValueError(f"{who}: at most 65535 blocks wider than {MAX_W}")
    if D.data_ptr() % 16:
        D = D.clone()       # the kernels load 16 bytes a thread
    libs = build()
    Dinv = torch.empty_like(D)
    pivs = torch.empty((K, W), dtype=D.dtype, device=D.device)
    nbad = torch.empty((K,), dtype=torch.int32, device=D.device)
    if K == 0:
        return Dinv, pivs, nbad
    suffix = "f64" if D.dtype == torch.float64 else "f32"
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        if wide:
            scratch = torch.empty((K * (2 * W * NB + NB * NB),),
                                  dtype=D.dtype, device=D.device)
            err = getattr(libs["wide"], f"gj_inverse_wide_{suffix}")(
                D.data_ptr(), Dinv.data_ptr(), pivs.data_ptr(),
                nbad.data_ptr(), scratch.data_ptr(), K, W, int(sanitize),
                stream)
        else:
            err = getattr(libs["narrow"], f"gj_inverse_{suffix}")(
                D.data_ptr(), Dinv.data_ptr(), pivs.data_ptr(),
                nbad.data_ptr(), K, W, int(sanitize), stream)
    if err != 0:
        raise RuntimeError(f"{who}: CUDA launch failed with error {err}")
    _count(K, W, 1)
    return Dinv, pivs, nbad


def _count(K, W, n):
    """Count `n` launches of K1 at (K, W)."""
    if W > MAX_W:
        gj_inverse.wide_launches += n
    else:
        gj_inverse.launches += n
    gj_inverse.shapes[K, W] = gj_inverse.shapes.get((K, W), 0) + n


@contextlib.contextmanager
def uncounted():
    """K1's launches inside the block are not counted (a CUDA graph's
    warm-up and capture).  Yields a dict that receives them, (K, W) ->
    launches, when the block ends."""
    saved = (gj_inverse.launches, gj_inverse.wide_launches,
             dict(gj_inverse.shapes))
    made = {}
    try:
        yield made
    finally:
        for key, n in gj_inverse.shapes.items():
            if n != saved[2].get(key, 0):
                made[key] = n - saved[2].get(key, 0)
        gj_inverse.launches, gj_inverse.wide_launches = saved[:2]
        gj_inverse.shapes.clear()
        gj_inverse.shapes.update(saved[2])


def count_replayed(made):
    """Count the K1 launches `made` ((K, W) -> launches, from `uncounted`)
    that one replay of a CUDA graph makes."""
    for (K, W), n in made.items():
        _count(K, W, n)
        gj_inverse.replayed[K, W] = gj_inverse.replayed.get((K, W), 0) + n


def gj_inverse(D):
    """Batched Gauss-Jordan inverse + pivots of a (K, W, W) f64/f32 tensor.
    Returns (Dinv, pivs); pivs[:, j] is the diagonal entry before step j.

    CUDA tensor: launches K1 on the current stream, the narrow kernel for
    W <= MAX_W and the wide (blocked) kernel above; the wide kernel's
    pivots equal the unblocked ones to rounding, with equal signs on
    quasi-definite blocks.  CPU tensor: `gj_inverse_ref`."""
    _check(D, "gj_inverse")
    if D.device.type == "cpu":
        return gj_inverse_ref(D)
    Dinv, pivs, _ = _launch(D, False, "gj_inverse")
    return Dinv, pivs


def gj_inverse_inertia(D):
    """`gj_inverse` with the inertia epilogue.  Returns (Dinv, pivs, nbad):
    nbad (K,) int32 counts, per block, the pivots that are negative,
    non-finite or below tiny (1e-250 in f64, 1e-25 in f32), and every
    non-finite entry of Dinv is stored as 0.

    CUDA tensor: the kernels compute both while they hold the block.  CPU
    tensor: the same in plain PyTorch after `gj_inverse_ref`."""
    _check(D, "gj_inverse_inertia")
    if D.device.type == "cuda":
        return _launch(D, True, "gj_inverse_inertia")
    Dinv, pivs = gj_inverse_ref(D)
    bad = ~torch.isfinite(pivs) | (pivs.abs() < _TINY[D.dtype])
    nbad = ((pivs < 0) | bad).sum(1, dtype=torch.int32)
    Dinv = torch.where(torch.isfinite(Dinv), Dinv, torch.zeros_like(Dinv))
    return Dinv, pivs, nbad


gj_inverse.launches = 0
gj_inverse.wide_launches = 0
# (K, W) -> launches of K1 at that shape, narrow and wide
gj_inverse.shapes = {}
# (K, W) -> launches of K1 at that shape replayed from CUDA graphs
gj_inverse.replayed = {}
