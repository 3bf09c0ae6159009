"""The family AD replayed from a CUDA graph (`BlockKKT._eval_core`): one
graph per key (lane count, Hessian mode, sigma, consts' shapes), the eager
pass on the CPU and for a key whose capture failed, the counters the fused
loop copies into `PSIOPT.LastFusedStats`, and, on a card, replays bitwise
equal to the eager pass."""

import numpy as np
import pytest
import torch

import asset_asrl_torch as tast
from asset_asrl_torch.parallel import solve_ensemble
from chip_smoke import build_brachistochrone, build_cartpole

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")

MODES = [True, "zeros", False]


def block_kkt(phase):
    phase.optimizer.set_PrintLevel(3)
    phase.transcribe()
    return phase.optimizer.kkt


def inputs(kkt, lanes, seed):
    """Seeded (x, lamE, lamI) of `lanes` lanes near the phase's guess."""
    nlp, dev = kkt.nlp, kkt.device
    rng = np.random.default_rng(seed)
    base = np.asarray(kkt._x0)
    x = base[None] * (1 + 1e-3 * rng.normal(size=(lanes, base.size)))
    return [tast.config.tensor(a, dev) for a in (
        x, rng.normal(size=(lanes, nlp.numEq)),
        np.abs(rng.normal(size=(lanes, nlp.numIq))))]


def leaves(tree):
    """The tensors of an `_eval_core` result, in order (None skipped)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [] if tree is None else [tree]


def same(a, b):
    """Bitwise equal results."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for s, t in zip(la, lb):
        assert s.shape == t.shape and s.dtype == t.dtype
        assert torch.equal(s, t)


class FakeGraph:
    """A stand-in for a captured pass: the eager pass, counted."""

    def __init__(self, kkt, sigma, want_hess):
        self.kkt, self.sigma, self.want_hess = kkt, sigma, want_hess
        self.calls = 0

    def __call__(self, x, lamE, lamI, consts):
        self.calls += 1
        return self.kkt._eval_eager(x, lamE, lamI, self.sigma, consts,
                                    self.want_hess)


@pytest.fixture
def cartpole_kkt():
    p = build_cartpole(tast, 8)
    kkt = block_kkt(p)
    kkt._x0 = p.makeSolverInput()
    return kkt


@pytest.mark.parametrize("want_hess", MODES, ids=str)
def test_cpu_block_kkt_runs_eagerly(cartpole_kkt, want_hess):
    """A CPU BlockKKT has no capture step: every pass is eager and
    counted, nothing is captured or replayed."""
    kkt = cartpole_kkt
    assert kkt._ad_capture is None
    x, lE, lI = inputs(kkt, 2, 0)
    consts = kkt.nlp.consts_dev()
    for _ in range(2):
        out = kkt._eval_core(x, lE, lI, 1.0, consts, want_hess)
    same(out, kkt._eval_eager(x, lE, lI, 1.0, consts, want_hess))
    assert kkt.ad_counts == dict(ad_captures=0, ad_capture_failures=0,
                                 ad_replays=0, ad_eager=2)
    assert kkt._ad_graphs == {}


def test_one_graph_per_lanes_mode_and_sigma(cartpole_kkt):
    """Each (lane count, Hessian mode, sigma) captures once and is
    replayed after; the same sigma as an int or a float is one key."""
    kkt = cartpole_kkt
    keys = []

    def capture(k, x, lamE, lamI, sigma, consts, want_hess):
        keys.append((x.shape[0], want_hess, sigma))
        return FakeGraph(k, sigma, want_hess)
    kkt._ad_capture = capture
    consts = kkt.nlp.consts_dev()
    combos = [(B, h, s) for B in (1, 3) for h in (True, "zeros")
              for s in (1.0, 0.0)]
    for seed in range(2):
        for B, h, s in combos:
            x, lE, lI = inputs(kkt, B, seed)
            same(kkt._eval_core(x, lE, lI, s, consts, h),
                 kkt._eval_eager(x, lE, lI, s, consts, h))
    assert keys == combos
    assert len(kkt._ad_graphs) == len(combos)
    assert all(g.calls == 2 for g in kkt._ad_graphs.values())
    x, lE, lI = inputs(kkt, 1, 5)
    kkt._eval_core(x, lE, lI, 1, consts, True)
    assert len(keys) == len(combos)
    assert kkt.ad_counts == dict(ad_captures=8, ad_capture_failures=0,
                                 ad_replays=17, ad_eager=0)


def test_failed_capture_stays_eager(cartpole_kkt):
    """A capture that raises is counted once, its key runs eagerly from
    then on and is never captured again; another key still captures."""
    kkt = cartpole_kkt
    tries = []

    def capture(k, x, lamE, lamI, sigma, consts, want_hess):
        tries.append(want_hess)
        if want_hess is True:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return FakeGraph(k, sigma, want_hess)
    kkt._ad_capture = capture
    consts = kkt.nlp.consts_dev()
    for seed in range(3):
        x, lE, lI = inputs(kkt, 2, seed)
        same(kkt._eval_core(x, lE, lI, 1.0, consts, True),
             kkt._eval_eager(x, lE, lI, 1.0, consts, True))
    x, lE, lI = inputs(kkt, 2, 9)
    kkt._eval_core(x, lE, lI, 1.0, consts, "zeros")
    assert tries == [True, "zeros"]
    assert kkt.ad_counts == dict(ad_captures=1, ad_capture_failures=1,
                                 ad_replays=1, ad_eager=3)


def test_capture_errors_other_than_runtime_propagate(cartpole_kkt):
    """Only a failed capture (a RuntimeError) falls back; any other
    error is the program's and is raised."""
    kkt = cartpole_kkt

    def capture(*a):
        raise ValueError("not a capture failure")
    kkt._ad_capture = capture
    x, lE, lI = inputs(kkt, 1, 0)
    with pytest.raises(ValueError):
        kkt._eval_core(x, lE, lI, 1.0, kkt.nlp.consts_dev(), True)


def test_last_fused_stats_carry_ad_counts():
    """A fused solve on the CPU runs every AD pass eagerly (the loop's and
    the multiplier start's); with a capture step every pass replays, and
    the solve is the same."""
    out = []
    for fake in (False, True):
        p = build_brachistochrone(tast, "LGL3", 8)
        kkt = block_kkt(p)
        if fake:
            kkt._ad_capture = lambda k, x, lE, lI, s, c, h: FakeGraph(k, s,
                                                                      h)
        assert p.optimize() == 0
        st = p.optimizer.LastFusedStats
        passes = st["iterations"] + 1
        assert (st["ad_replays"], st["ad_eager"]) == \
            ((passes, 0) if fake else (0, passes))
        out.append((st["iterations"], p.optimizer.LastObjVal))
    assert out[0] == out[1]


def test_ensemble_stats_carry_ad_counts():
    """`solve_ensemble` leaves the AD counters of its call in
    LastFusedStats."""
    p = build_brachistochrone(tast, "LGL3", 8)
    block_kkt(p)
    base = np.asarray(p.makeSolverInput())
    rng = np.random.default_rng(1)
    solve_ensemble(p, x0s=[base * (1 + 1e-4 * rng.normal(size=base.size))
                           for _ in range(3)])
    st = p.optimizer.LastFusedStats
    assert st["ad_replays"] == 0
    assert st["ad_eager"] == st["iterations"] + 1


def test_sharded_kkt_shares_the_counts():
    """The sharded wrapper evaluates through its base, so it reports the
    base's counters."""
    from asset_asrl_torch.Solvers.kkt_sharded import ShardedBlockKKT
    p = build_brachistochrone(tast, "LGL3", 8)
    kkt = block_kkt(p)
    wrapped = ShardedBlockKKT(kkt, tast.distributed.chain_mesh("seg", 2))
    assert wrapped.ad_counts is kkt.ad_counts


# ------------------------------------------------------------------ card
@pytest.fixture
def on_card():
    """Problems built inside the test live on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    asset_asrl_torch.config.use_device("cuda")
    try:
        yield
    finally:
        asset_asrl_torch.config.use_device("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 16])
@pytest.mark.parametrize("want_hess", [True, "zeros"], ids=str)
def test_replay_is_bitwise_the_eager_pass(on_card, lanes, want_hess):
    """Replays equal the eager pass bitwise in every output; a returned
    tensor keeps its values after the next replay; after `bump_consts`
    the same graph replays the new consts."""
    p = build_cartpole(tast, 40)
    kkt = block_kkt(p)
    kkt._x0 = p.makeSolverInput()
    nlp = kkt.nlp
    x, lE, lI = inputs(kkt, lanes, 1)
    first = kkt._eval_core(x, lE, lI, 1.0, nlp.consts_dev(), want_hess)
    kept = [t.clone() for t in leaves(first)]
    same(first, kkt._eval_eager(x, lE, lI, 1.0, nlp.consts_dev(),
                                want_hess))
    x2, lE2, lI2 = inputs(kkt, lanes, 2)
    second = kkt._eval_core(x2, lE2, lI2, 1.0, nlp.consts_dev(), want_hess)
    same(second, kkt._eval_eager(x2, lE2, lI2, 1.0, nlp.consts_dev(),
                                 want_hess))
    same(first, kept)
    assert not all(torch.equal(a, b) for a, b in zip(leaves(first),
                                                      leaves(second)))
    for f in nlp.objectives + nlp.eqcons + nlp.iqcons:
        f.consts[:] = f.consts * (1 + 1e-3)
    nlp.bump_consts()
    third = kkt._eval_core(x, lE, lI, 1.0, nlp.consts_dev(), want_hess)
    same(third, kkt._eval_eager(x, lE, lI, 1.0, nlp.consts_dev(),
                                want_hess))
    torch.cuda.synchronize()
    assert kkt.ad_counts["ad_captures"] == 1
    assert kkt.ad_counts["ad_replays"] == 3


@pytest.mark.cuda
def test_fused_solve_with_graphs_is_the_eager_solve(on_card):
    """The 40-segment CartPole solved with the family AD replayed and
    forced eager: the same flag, iterations, objective and answer,
    bitwise."""
    out = []
    for eager in (False, True):
        p = build_cartpole(tast, 40)
        kkt = block_kkt(p)
        if eager:
            kkt._ad_capture = None
        flag = p.optimize()
        opt = p.optimizer
        st = opt.LastFusedStats
        out.append((flag, opt.LastIterNum, opt.LastObjVal,
                    np.asarray(p.makeSolverInput())))
        if eager:
            assert st["ad_replays"] == 0 and st["ad_eager"] > 0
        else:
            assert st["ad_eager"] == 0
            assert st["ad_replays"] == st["iterations"] + 1
    (f1, n1, o1, x1), (f2, n2, o2, x2) = out
    assert (f1, n1, o1) == (f2, n2, o2)
    assert f1 == 0
    assert np.array_equal(x1, x2)


@pytest.mark.cuda
def test_host_read_in_a_family_falls_back_on_card(on_card):
    """A family that reads the host cannot be captured: its key runs
    eagerly (counted, not retried) and gives the eager answers; the card
    still captures the next BlockKKT's pass."""
    p = build_cartpole(tast, 16)
    kkt = block_kkt(p)
    kkt._x0 = p.makeSolverInput()
    fam = kkt._eq[0]
    vj = fam["vj"]

    def reads_host(xg, cb):
        float(xg.sum())
        return vj(xg, cb)
    fam["vj"] = reads_host
    x, lE, lI = inputs(kkt, 2, 3)
    consts = kkt.nlp.consts_dev()
    for _ in range(2):
        same(kkt._eval_core(x, lE, lI, 1.0, consts, True),
             kkt._eval_eager(x, lE, lI, 1.0, consts, True))
    assert kkt.ad_counts == dict(ad_captures=0, ad_capture_failures=1,
                                 ad_replays=0, ad_eager=2)

    q = build_cartpole(tast, 16)
    other = block_kkt(q)
    other._x0 = q.makeSolverInput()
    same(other._eval_core(x, lE, lI, 1.0, other.nlp.consts_dev(), True),
         other._eval_eager(x, lE, lI, 1.0, other.nlp.consts_dev(), True))
    assert other.ad_counts["ad_replays"] == 1
