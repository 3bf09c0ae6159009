"""Hand-written CUDA kernels of the block-KKT hot path, with their plain
PyTorch versions.

K1, `gj_inverse`: batched unpivoted Gauss-Jordan inverse + pivot sequence
(`csrc/gj_inverse.cu`).  It replaces the Pallas kernel
`asset_asrl_tpu/Solvers/pallas_kernels.py: batched_gj_inverse` and, on the
f64 main path, the XLA loop `kkt_block._inv_gj_pivots`.

The kernel is compiled at first use with `nvcc` (sm_90a) into a shared
library with a plain C interface, keyed by a hash of its source, under
`asset_asrl_torch/_build/`, and loaded with ctypes.  A CUDA tensor always
goes through the kernel; a CPU tensor takes `gj_inverse_ref`, the plain
PyTorch version (the tests run on the CPU).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "gj_inverse.cu")
_BUILD = os.path.join(_PKG, "_build")
MAX_W = 64
_GUARD = {torch.float64: 1e-300, torch.float32: 1e-30}
_lib = None


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return path


def build():
    """Compile (once per source hash) and load the kernel library.
    Returns the ctypes library."""
    global _lib
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD, f"libgj_inverse_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-o", tmp, _SRC], check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name in ("gj_inverse_f64", "gj_inverse_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


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


def gj_inverse(D):
    """Batched Gauss-Jordan inverse + pivots of a (K, W, W) f64/f32 tensor.

    CUDA tensor: launches the K1 kernel (one CTA per block) on the current
    stream.  CPU tensor: `gj_inverse_ref`."""
    if D.ndim != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"gj_inverse: expected (K, W, W), got "
                         f"{tuple(D.shape)}")
    if D.dtype not in _GUARD:
        raise ValueError(f"gj_inverse: dtype {D.dtype} not supported "
                         "(float64 or float32)")
    K, W, _ = D.shape
    if not 1 <= W <= MAX_W:
        raise ValueError(f"gj_inverse: block width {W} outside 1..{MAX_W}")
    if D.device.type == "cpu":
        return gj_inverse_ref(D)
    if D.device.type != "cuda":
        raise ValueError(f"gj_inverse: unsupported device {D.device}")
    if not D.is_contiguous():
        raise ValueError("gj_inverse: input must be contiguous")
    lib = build()
    Dinv = torch.empty_like(D)
    pivs = torch.empty((K, W), dtype=D.dtype, device=D.device)
    if K == 0:
        return Dinv, pivs
    fn = lib.gj_inverse_f64 if D.dtype == torch.float64 \
        else lib.gj_inverse_f32
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(D.data_ptr(), Dinv.data_ptr(), pivs.data_ptr(), K, W,
                 stream)
    if err != 0:
        raise RuntimeError(f"gj_inverse: CUDA launch failed with error "
                           f"{err}")
    gj_inverse.launches += 1
    return Dinv, pivs


gj_inverse.launches = 0
