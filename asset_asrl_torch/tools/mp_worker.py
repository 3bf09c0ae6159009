"""One of N processes that run the sharded KKT over a real process group
(gloo on the CPU) and check it.

    python -m asset_asrl_torch.tools.mp_worker <rank> <nproc> <port>

Each rank joins the group at 127.0.0.1:<port> and holds 4 shards: the
(nproc, 4) ("host", "chip") mesh of `host_chip_mesh(chips=4)`.  It then
factors and solves K, W, b = 40, 4, 2 hierarchically and flat (8 shards a
rank over `chain_mesh`), each against the dense solve (1e-8) and the exact
inertia; steps 4 lanes of a scenario batch split over the ranks against
the unsplit batch (1e-12); and solves a 16-segment CartPole with the
sharded backend over the (nproc, 4) mesh against the block backend (flag
equal, x to 1e-6 relative).  Prints "MP-OK" and the collective counts
when every check passes; exits non-zero otherwise.
"""

import sys

import numpy as np
import torch


def make_block_tridiag(K, W, b, seed=0, spd=False):
    """Seeded symmetric block-tridiagonal-plus-border blocks and the dense
    matrix: the generator and draw order of `tests/test_kkt_block.py`."""
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=(K, W, W))
    diag = (diag + diag.transpose(0, 2, 1)) / 2
    if spd:
        diag += W * np.eye(W)
    lower = rng.normal(size=(K, W, W)) * 0.3
    lower[-1] = 0.0
    B = rng.normal(size=(K, W, b)) * 0.2
    C = rng.normal(size=(b, b))
    C = (C + C.T) / 2 - b * np.eye(b)
    dim = K * W + b
    A = np.zeros((dim, dim))
    for k in range(K):
        A[k * W:(k + 1) * W, k * W:(k + 1) * W] = diag[k]
        if k + 1 < K:
            A[(k + 1) * W:(k + 2) * W, k * W:(k + 1) * W] = lower[k]
            A[k * W:(k + 1) * W, (k + 1) * W:(k + 2) * W] = lower[k].T
        A[k * W:(k + 1) * W, K * W:] = B[k]
        A[K * W:, k * W:(k + 1) * W] = B[k].T
    A[K * W:, K * W:] = C
    return diag, lower, B, C, A


def check(cond, what):
    if not cond:
        raise SystemExit(f"mp_worker: {what}")


def kkt_checks(ast, nproc):
    from asset_asrl_torch.Solvers.kkt_sharded import (
        pad_chain, sharded_factor, sharded_factor_hier, sharded_solve,
        sharded_solve_hier)
    K, W, b = 40, 4, 2
    D = 4 * nproc
    hier = ast.distributed.host_chip_mesh(chips=4)
    flat = ast.distributed.chain_mesh(shards=4)
    check(hier.shape == {"host": nproc, "chip": 4}, f"mesh {hier}")
    errs = []
    for mesh, factor, solve in ((hier, sharded_factor_hier,
                                 sharded_solve_hier),
                                (flat, sharded_factor, sharded_solve)):
        for seed, spd in ((3, True), (5, False)):
            diag, lower, B, C, A = make_block_tridiag(K, W, b, seed, spd)
            blocks = [ast.config.tensor(v)[None]
                      for v in (diag, lower, B, C)]
            dg, lo, Bp, Cp, L = pad_chain(*blocks, D)
            fac, neigs = factor(dg, lo, Bp, Cp, mesh)
            nneg = int(np.sum(np.linalg.eigvalsh(A) < 0))
            check(int(neigs[0]) == nneg,
                  f"inertia {int(neigs[0])} != {nneg} ({mesh}, {seed})")
            if not spd:
                continue
            rng = np.random.default_rng(7)
            r = rng.normal(size=(K, W))
            rb = rng.normal(size=(b,))
            rp = np.concatenate([r, np.zeros((D * L - K, W))])
            y, z = solve(fac, ast.config.tensor(rp)[None],
                         ast.config.tensor(rb)[None], mesh)
            sol = np.linalg.solve(A, np.concatenate([r.ravel(), rb]))
            got = np.concatenate([y[0, :K].numpy().ravel(), z[0].numpy()])
            errs.append(float(np.abs(got - sol).max()))
            check(errs[-1] < 1e-8, f"solve error {errs[-1]} ({mesh})")
    return max(errs), hier.calls, flat.calls


def batched_step_check(ast):
    from chip_smoke import build_brachistochrone
    from asset_asrl_torch import parallel
    phase = build_brachistochrone(ast, "LGL3", 8)
    phase.optimizer.set_PrintLevel(2)
    base = parallel.init_state(phase)
    rng = np.random.default_rng(1)
    x = np.stack([base[0].numpy() + rng.normal(size=base[0].shape) * 1e-3
                  for _ in range(4)])

    def start():
        return (ast.config.tensor(x),) + tuple(
            torch.stack([v] * 4) for v in base[1:])
    mesh = ast.distributed.chain_mesh(axis="scenario")
    outs = []
    for step in (parallel.make_batched_step(phase),
                 parallel.make_batched_step(phase, mesh=mesh)):
        st = start()
        for _ in range(2):
            st, info = step(st)
        outs.append((st, info))
    dev = max(float((a - b).abs().max())
              for a, b in zip(outs[0][0] + (outs[0][1],),
                              outs[1][0] + (outs[1][1],)))
    check(dev <= 1e-12, f"split batch differs by {dev}")
    return dev, mesh.calls


def phase_check(ast, nproc):
    from chip_smoke import build_cartpole
    xs, flags = [], []
    mesh = ast.distributed.host_chip_mesh(chips=4)
    for sharded in (False, True):
        ph = build_cartpole(ast, 16)
        ph.optimizer.set_PrintLevel(2)
        if sharded:
            ph.setKKTBackend("sharded", mesh=mesh)
        flags.append(ph.optimize())
        xs.append(ph.makeSolverInput())
    rel = np.abs(xs[0] - xs[1]).max() / max(1.0, np.abs(xs[0]).max())
    check(flags[0] == flags[1] == 0 and rel < 1e-6,
          f"sharded CartPole: flags {flags}, x off by {rel}")
    return rel, mesh.calls


def main(argv):
    rank, nproc, port = int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    import asset_asrl_torch as ast
    ast.config.use_device("cpu")
    ast.distributed.initialize(f"127.0.0.1:{port}", nproc, rank)
    err, hcalls, fcalls = kkt_checks(ast, nproc)
    dev, scalls = batched_step_check(ast)
    rel, pcalls = phase_check(ast, nproc)
    print(f"MP-OK rank={rank} kkt err={err:.2e} batch dev={dev:.1e} "
          f"cartpole rel={rel:.1e} collectives hier={hcalls} "
          f"flat={fcalls} batch={scalls} cartpole={pcalls}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
