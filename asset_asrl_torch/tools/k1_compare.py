"""Time kernel K1 beside an earlier K1 source, on one card, in one process.

    python3 -m asset_asrl_torch.tools.k1_compare --old-source OLD.cu \
        [--out FILE.json]

OLD.cu is an earlier revision of `csrc/gj_inverse.cu` with the interface
`gj_inverse[_wide]_f64(D, Dinv, pivs, K, W, stream)`: one CTA a block, no
inertia epilogue (take it from the repository's history with `git show`).
It is compiled with the flags `cuda_kernels.build` uses.  For each f64
shape the script prints one JSON line with the device time, in ms, of

    old         the earlier kernel alone
    old_sym     the earlier kernel followed by the plain epilogue that
                `kkt_block._inv_sym` ran after it (bad-pivot count, zero
                for non-finite entries): the same function as `new`
    new         `cuda_kernels.gj_inverse_inertia`

each as 10 calls replayed from a CUDA graph (no host work between the
launches), median of 20 replays, taken in the order old, new, new, old
(the two readings of each are both printed); and the largest relative
difference of the two inverses.  The card's name and power limit end the
output.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from asset_asrl_torch.Solvers import cuda_kernels as ck

# the reduction levels and widths of the solves in chip_smoke.py, and the
# borders of 250 and 256 segments a phase
SHAPES = [(2500, 24), (2501, 25), (156, 24), (1, 24), (514, 8), (25, 11),
          (65, 42), (1, 255), (1, 261)]


def build_old(source, workdir):
    so = os.path.join(workdir, "libgj_old.so")
    subprocess.run(
        [ck._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
         source], check=True)
    lib = ctypes.CDLL(so)
    for name in ("gj_inverse_f64", "gj_inverse_wide_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def blocks(K, W, seed):
    """Seeded symmetric quasi-definite blocks, as regularized KKT
    macro-blocks are."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, W, W))
    A = (A + A.transpose(0, 2, 1)) / 2
    h = (W + 1) // 2
    A[:, :h, :h] += W * np.eye(h)
    A[:, h:, h:] -= W * np.eye(W - h)
    return torch.tensor(A, dtype=torch.float64, device="cuda")


def graph_ms(fn, calls=10, reps=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) / calls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-source", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device visible", file=sys.stderr)
        return 1
    ck.build()
    rows = []
    with tempfile.TemporaryDirectory() as workdir:
        lib = build_old(args.old_source, workdir)
        for i, (K, W) in enumerate(SHAPES):
            D = blocks(K, W, 100 + i)
            fn = (lib.gj_inverse_wide_f64 if W > 64 else lib.gj_inverse_f64)

            def old():
                Dinv = torch.empty_like(D)
                pivs = torch.empty((K, W), dtype=D.dtype, device=D.device)
                err = fn(D.data_ptr(), Dinv.data_ptr(), pivs.data_ptr(), K,
                         W, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"old kernel: CUDA error {err}")
                return Dinv, pivs

            def old_sym():
                Dinv, pivs = old()
                bad = ~torch.isfinite(pivs) | (pivs.abs() < 1e-250)
                neg = ((pivs < 0) | bad).sum()
                Dinv = torch.where(torch.isfinite(Dinv), Dinv,
                                   torch.zeros_like(Dinv))
                return Dinv, neg

            def new():
                return ck.gj_inverse_inertia(D)

            Xo, Xn = old()[0], new()[0]
            torch.cuda.synchronize()
            t = [graph_ms(old), graph_ms(old_sym), graph_ms(new),
                 graph_ms(new), graph_ms(old_sym), graph_ms(old)]
            rows.append(dict(
                shape=[K, W, W], old_ms=[t[0], t[5]],
                old_sym_ms=[t[1], t[4]], new_ms=[t[2], t[3]],
                rel_diff=float((Xo - Xn).norm() / Xo.norm())))
            print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
