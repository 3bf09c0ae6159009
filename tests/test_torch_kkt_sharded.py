"""The port's segment-sharded KKT (`asset_asrl_torch.Solvers.kkt_sharded`)
against the JAX package's, mirroring `tests/test_kkt_sharded.py`: the same
seeded `make_block_tridiag` inputs go through JAX's sharded factor/solve
(jitted on the 8-device virtual CPU mesh) and the port's, whose 8 shards
lie on this process's lane axis (one rank, no process group).  Then the
user API: `setKKTBackend("sharded")` on a phase and a two-phase OCP, and
the fused solve with a `ShardedBlockKKT`, each against the block backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from asset_asrl_tpu.Solvers import kkt_sharded as jks
import asset_asrl_torch as tast
from asset_asrl_torch.distributed import Mesh, chain_mesh, host_chip_mesh
from asset_asrl_torch.Solvers import kkt_sharded as tks
from asset_asrl_torch.Solvers.kkt_block import BlockKKT, bcr_factor, \
    bcr_solve
from asset_asrl_torch.tools.mp_worker import make_block_tridiag as \
    worker_blocks
from chip_smoke import build_cartpole
from tests.test_kkt_block import make_block_tridiag

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

# the meshes of the tests: shape -> axis names (two axes: hierarchical)
MESHES = {(8,): ("seg",), (2, 4): ("host", "chip"), (4, 2): ("host", "chip")}


def jax_mesh(shape):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return JMesh(np.array(devs[:8]).reshape(shape), MESHES[shape])


def jax_run(shape, blocks, r=None, rb=None):
    """JAX's sharded factor (and solve) on the virtual mesh: (neigs, y,
    z) with y cut to K blocks."""
    mesh = jax_mesh(shape)
    K, W = blocks[0].shape[:2]
    hier = len(shape) == 2
    factor = jks.sharded_factor_hier if hier else jks.sharded_factor
    solve = jks.sharded_solve_hier if hier else jks.sharded_solve
    dg, lo, Bp, Cp, L = jks.pad_chain(*map(jnp.asarray, blocks), 8)
    fac, neigs = jax.jit(lambda *a: factor(*a, mesh))(dg, lo, Bp, Cp)
    if r is None:
        return int(neigs), None, None
    rp = jnp.asarray(np.concatenate([r, np.zeros((8 * L - K, W))]))
    y, z = jax.jit(lambda *a: solve(*a, mesh))(fac, rp, jnp.asarray(rb))
    return int(neigs), np.asarray(y)[:K], np.asarray(z)


def torch_run(shape, blocks, r=None, rb=None):
    """The port's sharded factor (and solve), one lane, the mesh on this
    process: (neigs, y, z) with y cut to K blocks."""
    mesh = Mesh(shape, MESHES[shape])
    K, W = blocks[0].shape[:2]
    hier = len(shape) == 2
    factor = tks.sharded_factor_hier if hier else tks.sharded_factor
    solve = tks.sharded_solve_hier if hier else tks.sharded_solve
    dg, lo, Bp, Cp, L = tks.pad_chain(
        *[torch.tensor(v)[None] for v in blocks], 8)
    fac, neigs = factor(dg, lo, Bp, Cp, mesh)
    assert neigs.shape == (1,)
    if r is None:
        return int(neigs[0]), None, None
    rp = torch.tensor(np.concatenate([r, np.zeros((8 * L - K, W))]))
    y, z = solve(fac, rp[None], torch.tensor(rb)[None], mesh)
    return int(neigs[0]), y[0, :K].numpy(), z[0].numpy()


def solve_both(shape, K, W, b, seed):
    diag, lower, B, C, A = make_block_tridiag(K, W, b, seed=seed, spd=True)
    rng = np.random.default_rng(seed + 1)
    r = rng.normal(size=(K, W))
    rb = rng.normal(size=(b,))
    blocks = (diag, lower, B, C)
    jn, jy, jz = jax_run(shape, blocks, r, rb)
    tn, ty, tz = torch_run(shape, blocks, r, rb)
    nneg = int(np.sum(np.linalg.eigvalsh(A) < 0))
    assert tn == jn == nneg
    assert np.max(np.abs(ty - jy), initial=0.0) <= 1e-10
    assert np.max(np.abs(tz - jz), initial=0.0) <= 1e-10
    sol = np.linalg.solve(A, np.concatenate([r.ravel(), rb]))
    got = np.concatenate([ty.ravel(), tz])
    assert np.allclose(got, sol, atol=1e-8), np.abs(got - sol).max()
    return ty, tz, (diag, lower, B, C), r, rb


@pytest.mark.parametrize("K,W,b", [(16, 3, 2), (33, 4, 3), (40, 5, 0),
                                   (129, 4, 2)])
def test_sharded_solve_matches_dense(K, W, b):
    """D = 8 flat: neigs equal to JAX's and eigvalsh's, y and z within
    1e-10 of JAX's, the dense solve to 1e-8 (b = 0 included)."""
    solve_both((8,), K, W, b, seed=K + W)


@pytest.mark.parametrize("K,W,b", [(24, 3, 2), (65, 4, 3)])
def test_sharded_inertia_matches_dense(K, W, b):
    """Indefinite blocks: the sharded inertia equals JAX's and the exact
    one, flat and hierarchical."""
    for seed in range(3):
        diag, lower, B, C, A = make_block_tridiag(K, W, b, seed=seed)
        nneg = int(np.sum(np.linalg.eigvalsh(A) < 0))
        for shape in ((8,), (2, 4)):
            blocks = (diag, lower, B, C)
            assert torch_run(shape, blocks)[0] == jax_run(shape, blocks)[0] \
                == nneg, (seed, shape)


def test_sharded_matches_single_chip():
    """One-device BCR and the 8-shard substructuring agree (1e-9), and
    their inertias are equal."""
    K, W, b = 50, 4, 2
    ty, tz, blocks, r, rb = solve_both((8,), K, W, b, seed=3)
    fac, n1 = bcr_factor(*[torch.tensor(v)[None] for v in blocks])
    y1, z1 = bcr_solve(fac, torch.tensor(r)[None], torch.tensor(rb)[None])
    assert int(n1[0]) == torch_run((8,), blocks)[0]
    assert np.allclose(ty, y1[0].numpy(), atol=1e-9)
    assert np.allclose(tz, z1[0].numpy(), atol=1e-9)


@pytest.mark.parametrize("K,W,b,hc", [(40, 4, 2, (2, 4)),
                                      (25, 3, 0, (4, 2))])
def test_hier_sharded_matches_dense(K, W, b, hc):
    """Two-level (host x chip) substructuring: neigs of an SPD and an
    indefinite matrix equal to JAX's and eigvalsh's; y and z within 1e-10
    of JAX's and the dense solve to 1e-8."""
    solve_both(hc, K, W, b, seed=0)
    diag, lower, B, C, A = make_block_tridiag(K, W, b, seed=5, spd=False)
    nneg = int(np.sum(np.linalg.eigvalsh(A) < 0))
    blocks = (diag, lower, B, C)
    assert torch_run(hc, blocks)[0] == jax_run(hc, blocks)[0] == nneg


def test_lanes_of_one_factor_match_their_solo_factors():
    """Three solver lanes in one sharded factor and solve (every level of
    every shard of every lane one batch) equal each lane's own."""
    mesh = Mesh((2, 4), ("host", "chip"))
    K, W, b = 30, 3, 2
    lanes = [make_block_tridiag(K, W, b, seed=s, spd=s != 1)
             for s in range(3)]
    stack = [torch.tensor(np.stack([ln[i] for ln in lanes]))
             for i in range(4)]
    dg, lo, Bp, Cp, L = tks.pad_chain(*stack, 8)
    rng = np.random.default_rng(4)
    r = torch.tensor(rng.normal(size=(3, 8 * L, W)))
    rb = torch.tensor(rng.normal(size=(3, b)))
    fac, neigs = tks.sharded_factor_hier(dg, lo, Bp, Cp, mesh)
    y, z = tks.sharded_solve_hier(fac, r, rb, mesh)
    for i in range(3):
        f1, n1 = tks.sharded_factor_hier(dg[i:i + 1], lo[i:i + 1],
                                         Bp[i:i + 1], Cp[i:i + 1], mesh)
        y1, z1 = tks.sharded_solve_hier(f1, r[i:i + 1], rb[i:i + 1], mesh)
        assert int(neigs[i]) == int(n1[0])
        assert torch.allclose(y[i], y1[0], atol=1e-10, rtol=0)
        assert torch.allclose(z[i], z1[0], atol=1e-10, rtol=0)


def test_worker_blocks_are_the_tests_blocks():
    """The multi-process worker builds the same inputs as the tests."""
    for a, b in zip(worker_blocks(13, 3, 2, 3, True),
                    make_block_tridiag(13, 3, 2, seed=3, spd=True)):
        assert np.array_equal(a, b)


def rel_x(x1, x2):
    return np.max(np.abs(x1 - x2)) / max(1.0, np.abs(x1).max())


@pytest.fixture(scope="module")
def block_cartpole():
    ph = build_cartpole(tast, 16)
    ph.optimizer.set_PrintLevel(2)
    flag = ph.optimize()
    return flag, ph.makeSolverInput(), ph.optimizer.kkt.bs.K


@pytest.mark.parametrize("shape", [(8,), (2, 4)])
def test_phase_sharded_backend_user_api(block_cartpole, shape):
    """`phase.setKKTBackend("sharded", mesh=)` routes the default solve
    through a `ShardedBlockKKT` (flat over 8 shards, hierarchical over a
    (2, 4) mesh) and gives the block backend's flag and x to 1e-6
    relative; a new segment count re-shards."""
    f1, x1, K1 = block_cartpole
    mesh = Mesh(shape, MESHES[shape])
    ph = build_cartpole(tast, 16)
    ph.optimizer.set_PrintLevel(2)
    ph.setKKTBackend("sharded", mesh=mesh)
    ph.transcribe()
    kkt = ph.optimizer.kkt
    assert isinstance(kkt, tks.ShardedBlockKKT)
    assert kkt.hier == (len(shape) == 2) and kkt.D == 8
    flag = ph.optimize()
    assert f1 == flag == 0
    assert rel_x(x1, ph.makeSolverInput()) < 1e-6
    ph.refineTrajManual(20)
    ph.transcribe()
    assert isinstance(ph.optimizer.kkt, tks.ShardedBlockKKT)
    assert ph.optimizer.kkt is not kkt and ph.optimizer.kkt.bs.K != K1
    # a new mesh re-shards too
    ph.setKKTBackend("sharded", mesh=chain_mesh(shards=4))
    ph.transcribe()
    assert ph.optimizer.kkt.D == 4 and not ph.optimizer.kkt.hier


def test_sharded_full_solve_matches_single():
    """The fused PSIOPT solve with a `ShardedBlockKKT` over 8 shards gives
    the block backend's flag and x to 1e-6 relative."""
    from asset_asrl_torch.Solvers.fused import build_fused_alg
    ph = build_cartpole(tast, 16)
    ph.optimizer.set_PrintLevel(2)
    ph.transcribe()
    opt = ph.optimizer
    kkt = opt.kkt
    assert isinstance(kkt, BlockKKT)
    x, s, lamE, lamI = opt._init_state(ph.makeSolverInput(), opt.initMu)
    state = (x[None], s[None], lamE[None], lamI[None], float(opt.initMu),
             opt.nlp.consts_dev())
    out1 = build_fused_alg(kkt, opt._opts_snapshot(), "OPT")(*state)
    outD = build_fused_alg(tks.ShardedBlockKKT(kkt, chain_mesh(shards=8)),
                           opt._opts_snapshot(), "OPT")(*state)
    assert int(out1[5][0]) == int(outD[5][0]) == 0
    assert rel_x(out1[0][0].numpy(), outD[0][0].numpy()) < 1e-6


def test_ocp_sharded_backend_user_api():
    """A two-phase OCP through `ocp.setKKTBackend("sharded")` (the
    concatenated phase chain over 8 shards) gives the block backend's flag
    and trajectories to 1e-6."""
    vf, oc = tast.VectorFunctions, tast.OptimalControl
    A = vf.Arguments

    class DI(oc.ODEBase):
        def __init__(self):
            XtU = oc.ODEArguments(2, 1)
            super().__init__(vf.stack([XtU.XVar(1), XtU.UVar(0)]), 2, 1)

    def build():
        phases = []
        for k in range(2):
            ts = np.linspace(k, k + 1, 12)
            IG = [[0.5 * t, 0.5, t, 0.0] for t in ts]
            p = DI().phase("LGL3", IG, 10)
            p.addIntegralObjective(A(1)[0] ** 2, [3])
            phases.append(p)
        phases[0].addBoundaryValue("Front", [0, 1, 2], [0, 0, 0])
        phases[1].addBoundaryValue("Back", [0, 1, 2], [1, 0, 2])
        o = oc.OptimalControlProblem()
        o.addPhase(phases[0])
        o.addPhase(phases[1])
        o.addForwardLinkEqualCon(phases[0], phases[1], [0, 1, 2])
        o.optimizer.set_PrintLevel(2)
        return o

    o1 = build()
    f1 = o1.optimize()
    x1 = np.concatenate([np.asarray(p.returnTraj()).ravel()
                         for p in o1.Phases])
    o2 = build()
    o2.setKKTBackend("sharded", mesh=chain_mesh(shards=8))
    o2.transcribe()
    assert isinstance(o2.optimizer.kkt, tks.ShardedBlockKKT)
    f2 = o2.optimize()
    x2 = np.concatenate([np.asarray(p.returnTraj()).ravel()
                         for p in o2.Phases])
    assert f1 == f2 == 0
    assert np.max(np.abs(x1 - x2)) < 1e-6


def test_default_mesh_and_bad_backend():
    """The sharded backend's default mesh is `chain_mesh(axis)`: one shard
    on this one-process run, the flat path; `host_chip_mesh` on one rank
    is (1, chips) and shards flat over its chip axis, as JAX's
    `ShardedBlockKKT` does with a (1, C) mesh; an unknown backend
    raises."""
    ph = build_cartpole(tast, 4)
    ph.setKKTBackend("sharded")
    assert ph.KKTMesh.shape == {"seg": 1} and ph.KKTAxis == "seg"
    ph.transcribe()
    kkt = ph.optimizer.kkt
    assert isinstance(kkt, tks.ShardedBlockKKT) and kkt.D == 1
    kkt = tks.ShardedBlockKKT(kkt._base, host_chip_mesh(chips=4))
    assert not kkt.hier and (kkt.axis, kkt.D) == ("chip", 4)
    with pytest.raises(ValueError, match="unknown KKT backend"):
        ph.setKKTBackend("pardiso")
