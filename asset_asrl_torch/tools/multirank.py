"""The sharded KKT over several ranks: one process a card (or a CPU process
on gloo), against the block backend in the same call.

    python3 -m asset_asrl_torch.tools.multirank --ranks 4 [--nsegs 5000]
    python3 -m asset_asrl_torch.tools.multirank --ranks 4 --nsegs 40 --cpu

The launcher builds K1 (on a card), starts `--ranks` processes joined in
one process group at 127.0.0.1 (NCCL, rank r on card r; gloo with
`--cpu`) and waits for them.  Every rank solves the CartPole of
`chip_smoke.build_cartpole` (LGL5, `--nsegs` segments; 5000 is 10,001
nodes) with the default solve, `--turns` times in turns: on the block
backend (each rank alone), sharded flat over 8 shards
(`chain_mesh(shards=8 / ranks)`) and hierarchically over a (ranks,
8 / ranks) ("host", "chip") mesh when both sides are 2 or more.  A rank
fails unless every sharded solve gives the block solve's flag (0),
objective to 1e-9 relative and iterations within 1, and every rank the
same objective bits.  Rank 0 prints one JSON line: each solve's seconds,
iterations, objective, K1 launches, collective calls and peak device
memory, and the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(args):
    """Start the ranks and wait; returns the exit code."""
    if not args.cpu:
        if torch.cuda.device_count() < args.ranks:
            print(f"multirank: {args.ranks} ranks need as many cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 1
        from asset_asrl_torch.Solvers import cuda_kernels
        cuda_kernels.build()
    port = free_port()
    cmd = [sys.executable, "-m", "asset_asrl_torch.tools.multirank",
           "--ranks", str(args.ranks), "--nsegs", str(args.nsegs),
           "--turns", str(args.turns), "--port", str(port)] \
        + (["--cpu"] if args.cpu else [])
    logs = tempfile.mkdtemp(prefix="multirank_")
    files = [open(os.path.join(logs, f"rank{r}.log"), "w+")
             for r in range(args.ranks)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=f,
                              stderr=subprocess.STDOUT, text=True)
             for r, f in enumerate(files)]
    # a rank that fails leaves the others waiting in a collective: stop
    # them all at the first failure, or at the time limit
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() - t0 > args.timeout:
                break
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, (p, f) in enumerate(zip(procs, files)):
        f.seek(0)
        out = f.read()
        f.close()
        if p.returncode != 0 or r == 0:
            print(f"--- rank {r}, exit {p.returncode}")
            print(out[-8000:])
    shutil.rmtree(logs)
    return max(abs(p.returncode) for p in procs)


def worker(args):
    torch.set_num_threads(2)
    import asset_asrl_torch as ast
    from asset_asrl_torch.Solvers import cuda_kernels as ck
    import chip_smoke
    dist = torch.distributed
    if args.cpu:
        ast.config.use_device("cpu")
    ast.distributed.initialize(f"127.0.0.1:{args.port}", args.ranks,
                               args.rank, local_device_ids=args.rank)
    cuda = ast.config.DEVICE.type == "cuda"
    dev = ast.config.DEVICE
    shards = 8 // args.ranks
    meshes = [("block", None),
              ("flat D=8", ast.distributed.chain_mesh(shards=shards))]
    if args.ranks >= 2 and shards >= 2:
        meshes.append((f"hierarchical ({args.ranks}, {shards})",
                       ast.distributed.host_chip_mesh(chips=shards)))
    runs = []
    for turn in range(args.turns):
        for label, mesh in meshes:
            ph = chip_smoke.build_cartpole(ast, args.nsegs)
            opt = ph.optimizer
            opt.set_PrintLevel(2)
            if mesh is not None:
                ph.setKKTBackend("sharded", mesh=mesh)
            ph.transcribe()
            calls = dict(mesh.calls) if mesh is not None else {}
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                held = torch.cuda.memory_allocated(dev)
            dist.barrier()
            ck.gj_inverse.launches = ck.gj_inverse.wide_launches = 0
            t0 = time.perf_counter()
            flag = ph.optimize()
            if cuda:
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            obj = float(opt.LastObjVal)
            objs = torch.tensor([obj, -obj], dtype=torch.float64,
                                device=dev)
            dist.all_reduce(objs, op=dist.ReduceOp.MAX)
            runs.append(dict(
                solve=label, turn=turn, flag=int(flag),
                iterations=int(opt.LastIterNum), objective=obj,
                same_on_every_rank=float(objs[0]) == obj == -float(objs[1]),
                seconds=secs, k1_launches=ck.gj_inverse.launches,
                collectives={k: mesh.calls[k] - calls[k] for k in calls},
                peak_mib=(torch.cuda.max_memory_allocated(dev) - held)
                / 2**20 if cuda else None))
            del ph, opt
    block = [r for r in runs if r["solve"] == "block"]
    ref = block[0]
    bad = [r for r in runs if not (
        r["flag"] == ref["flag"] == 0 and r["same_on_every_rank"]
        and abs(r["iterations"] - ref["iterations"]) <= 1
        and abs(r["objective"] - ref["objective"])
        <= 1e-9 * abs(ref["objective"]))]
    if args.rank == 0:
        card = None
        if cuda:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        fastest = min(r["seconds"] for r in block)
        for r in runs:
            r["x_faster_block"] = r["seconds"] / fastest
        print(json.dumps(dict(ranks=args.ranks, nsegs=args.nsegs,
                              backend=dist.get_backend(), card=card,
                              torch=torch.__version__, runs=runs)))
    dist.destroy_process_group()
    if bad:
        print(f"multirank rank {args.rank}: solves off the block solve: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--nsegs", type=int, default=5000)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    if 8 % args.ranks:
        ap.error("--ranks must divide 8")
    sys.path.insert(0, os.getcwd())      # chip_smoke.build_cartpole
    if args.rank is None:
        return launch(args)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
