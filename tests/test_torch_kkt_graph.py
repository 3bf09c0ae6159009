"""The fused loop's block KKT replayed from CUDA graphs cut at the ladder's
host reads (`fused._KKTGraphs`): eager on the CPU and for
`ShardedBlockKKT`, one set of graphs per key (what the stretches compute
with and their inputs' layouts) shared by the passes and solves of one
BlockKKT, a failed capture eager from then on, the counters in
`PSIOPT.LastFusedStats`, and, on a card, solves bitwise equal to the
eager KKT with as many K1 launches."""

import numpy as np
import pytest
import torch

import asset_asrl_torch as tast
from asset_asrl_torch.Solvers import fused
from asset_asrl_torch.Solvers.cuda_kernels import gj_inverse
from asset_asrl_torch.Solvers.kkt_block import _copy_out, _leaves
from asset_asrl_torch.parallel import solve_ensemble
from chip_smoke import build_cartpole

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


class FakeGraphed:
    """A stand-in for `_Graphed` on the CPU with a graph's memory: static
    copies of the inputs, and outputs that every replay writes into the
    same tensors, so that a rung's in-place update and the direction's
    reads of the first factorization's buffers are exercised."""
    made = []
    capturing = False

    def __init__(self, fn, inputs, pool, device=None):
        self.fn, self.calls = fn, 0
        self.inputs = [t.clone() for t in inputs]
        FakeGraphed.capturing = True
        try:
            self.outputs = fn(*self.inputs)
        finally:
            FakeGraphed.capturing = False
        FakeGraphed.made.append(self)

    def run(self, *inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        for dst, src in zip(_leaves(self.outputs),
                            _leaves(self.fn(*self.inputs))):
            if dst is not src:
                dst.copy_(src)
        self.calls += 1
        return self.outputs

    def __call__(self, *inputs):
        return _copy_out(self.run(*inputs))


def phase(nsegs=8, kkt_graphs=None):
    """The cart-pole (path bounds, so inequalities and the barrier
    probe) with `kkt_graphs` as its BlockKKT's graph cache."""
    p = build_cartpole(tast, nsegs)
    p.optimizer.set_PrintLevel(3)
    p.transcribe()
    p.optimizer.kkt._kkt_graphs = kkt_graphs
    return p


def solved(p, schedule="optimize"):
    """(flag, iterations, objective, answer, stats) of one fused solve."""
    flag = getattr(p, schedule)()
    opt = p.optimizer
    return (flag, opt.LastIterNum, opt.LastObjVal,
            np.asarray(p.makeSolverInput()), dict(opt.LastFusedStats))


def same_solve(a, b):
    assert a[:3] == b[:3] and np.array_equal(a[3], b[3])
    assert a[4]["factorizations"] == b[4]["factorizations"]
    assert a[4]["k1_launches"] == b[4]["k1_launches"]


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(fused, "_Graphed", FakeGraphed)
    FakeGraphed.made = []
    return FakeGraphed


def test_cpu_kkt_runs_eagerly():
    """A CPU BlockKKT keeps no graphs: every iteration's KKT is eager and
    counted."""
    p = build_cartpole(tast, 8)
    p.optimizer.set_PrintLevel(3)
    flag, iters, _, _, st = solved(p)
    kkt = p.optimizer.kkt
    assert flag == 0 and kkt._kkt_graphs is None
    assert (st["kkt_replays"], st["kkt_eager"]) == (0, iters)
    assert st["k1_replayed"] == 0
    assert kkt.kkt_counts == dict(kkt_captures=0, kkt_capture_failures=0,
                                  kkt_replays=0, kkt_eager=iters)


@pytest.mark.parametrize("schedule,keys", [("optimize", 1),
                                           ("solve_optimize", 2)])
def test_one_set_of_graphs_per_key_shared_by_passes_and_solves(
        fake, schedule, keys):
    """With a capture step every iteration's KKT replays, rungs included,
    and the solve is the eager one; an SOE pass and an OPT pass are two
    keys of three graphs each; a second solve captures nothing new."""
    plain = solved(phase(), schedule)
    p = phase(kkt_graphs={})
    got = solved(p, schedule)
    same_solve(got, plain)
    st, kkt = got[4], p.optimizer.kkt
    assert st["factorizations"] > st["iterations"] + st["passes"]
    assert (st["kkt_replays"], st["kkt_eager"]) == (st["iterations"], 0)
    assert len(kkt._kkt_graphs) == keys
    assert len(fake.made) == kkt.kkt_counts["kkt_captures"] == 3 * keys
    again = solved(p, schedule)
    assert again[0] == 0 and len(fake.made) == 3 * keys
    # a key's graphs: first factorization, rung, direction
    rungs = sum(g.calls for i, g in enumerate(fake.made) if i % 3 == 1)
    assert rungs == st["factorizations"] + again[4]["factorizations"] \
        - st["iterations"] - again[4]["iterations"] \
        - st["passes"] - again[4]["passes"]


def test_solves_read_the_factor_in_the_eager_layout(fake):
    """A replayed solve reads the kept factor in the layout the eager
    ladder leaves it, since products round by layout: the first
    factorization's strided views, which the rungs write into."""
    def layouts(p):
        kkt, seen = p.optimizer.kkt, []
        plain = kkt._solve_impl

        def spy(fac, rhs_x, rhs_E):
            if not fake.capturing:
                seen.append([t.stride() for t in _leaves(fac)])
            return plain(fac, rhs_x, rhs_E)
        kkt._solve_impl = spy
        solved(p)
        return seen
    eager = layouts(phase())
    # the start's factor, and the loop's before and after a rung alike
    assert len({str(x) for x in eager}) == 2
    assert layouts(phase(kkt_graphs={})) == eager


def test_failed_capture_stays_eager(monkeypatch):
    """A capture that raises a RuntimeError is tried once a key; that key
    runs eagerly from then on and the solve is unchanged."""
    tries = []

    def capture(fn, inputs, pool, device=None):
        tries.append(1)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(fused, "_Graphed", capture)
    plain = solved(phase())
    p = phase(kkt_graphs={})
    got = solved(p)
    same_solve(got, plain)
    assert tries == [1]
    assert (got[4]["kkt_replays"], got[4]["kkt_eager"]) == (0, got[1])
    assert p.optimizer.kkt.kkt_counts["kkt_capture_failures"] == 1
    assert list(p.optimizer.kkt._kkt_graphs.values()) == [None]


def test_capture_errors_other_than_runtime_propagate(monkeypatch):
    def capture(*a, **k):
        raise ValueError("not a capture failure")
    monkeypatch.setattr(fused, "_Graphed", capture)
    with pytest.raises(ValueError):
        solved(phase(kkt_graphs={}))


def test_sharded_kkt_is_eager(fake):
    """`ShardedBlockKKT` runs its KKT eagerly whatever its base holds, and
    counts into its base's counters."""
    from asset_asrl_torch.Solvers.kkt_sharded import ShardedBlockKKT
    p = build_cartpole(tast, 8)
    p.optimizer.set_PrintLevel(3)
    p.setKKTBackend("sharded", mesh=tast.distributed.chain_mesh("seg", 2))
    p.transcribe()
    kkt = p.optimizer.kkt
    assert isinstance(kkt, ShardedBlockKKT) and kkt._kkt_graphs is None
    kkt._base._kkt_graphs = {}
    assert kkt.kkt_counts is kkt._base.kkt_counts
    flag, iters, _, _, st = solved(p)
    assert flag == 0 and fake.made == [] and kkt._base._kkt_graphs == {}
    assert (st["kkt_replays"], st["kkt_eager"]) == (0, iters)


def starts(p, lanes, scale, seed=5):
    base = np.asarray(p.makeSolverInput())
    rng = np.random.default_rng(seed)
    return [base * (1 + scale * rng.normal(size=base.size))
            for _ in range(lanes)]


def ensemble(p, x0s):
    out = solve_ensemble(p, x0s=x0s)
    return out, dict(p.optimizer.LastFusedStats)


def climbs_differ(out):
    """Some iteration in which the lanes took different numbers of
    rungs (`nfacs`, the record's column 7)."""
    nfacs = out["infos"][:, :, fused.INFO_FIELDS.index("nfacs")]
    its = int(out["iters"].min())
    return bool((nfacs[:, :its].min(0) != nfacs[:, :its].max(0)).any())


def test_ensemble_counts_and_lanes_that_climb_apart(fake):
    """`solve_ensemble` leaves its call's KKT counters in LastFusedStats:
    every iteration eager on the CPU, every one replayed with a capture
    step; and with lanes that take different numbers of rungs, the
    replayed ensemble is the eager one, bitwise."""
    plain_p = phase()
    x0s = starts(plain_p, 4, 0.05)
    plain, pst = ensemble(plain_p, x0s)
    assert pst["kkt_replays"] == 0
    assert pst["kkt_eager"] == pst["iterations"]
    assert climbs_differ(plain)
    got, st = ensemble(phase(kkt_graphs={}), x0s)
    for k in ("x", "flags", "iters", "objs", "infos", "lamE", "lamI", "s"):
        assert np.array_equal(got[k], plain[k]), k
    assert (st["kkt_replays"], st["kkt_eager"]) == (st["iterations"], 0)
    assert st["factorizations"] == pst["factorizations"]


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


def _card_problem(problem):
    if problem == "cartpole":
        p = build_cartpole(tast, 40)
    else:
        from asset_asrl_torch.examples.Delta3Launch import build_ocp
        p = build_ocp(8)
    p.optimizer.set_PrintLevel(3)
    p.transcribe()
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("problem,schedule", [
    ("cartpole", "optimize"), ("delta3", "solve_optimize")])
def test_fused_solve_with_kkt_graphs_is_the_eager_solve(on_card, problem,
                                                        schedule):
    """The 40-segment CartPole and Delta III at 8 segments a phase (two
    passes, links) solved with the block KKT replayed and eager: the same
    flag, iterations, objective, answer (bitwise), factorizations and K1
    launches."""
    out = []
    for eager in (False, True):
        p = _card_problem(problem)
        if eager:
            p.optimizer.kkt._kkt_graphs = None
        n0 = gj_inverse.launches + gj_inverse.wide_launches
        got = solved(p, schedule)
        torch.cuda.synchronize()
        st = got[4]
        assert n0 + st["k1_launches"] == \
            gj_inverse.launches + gj_inverse.wide_launches
        if eager:
            assert (st["kkt_replays"], st["kkt_eager"]) == \
                (0, st["iterations"])
            assert st["k1_replayed"] == 0
            assert not any(k.startswith("k1_replayed.") for k in st)
        else:
            assert (st["kkt_replays"], st["kkt_eager"]) == \
                (st["iterations"], 0)
            assert 0 < st["k1_replayed"] <= st["k1_launches"]
            assert st["k1_replayed"] == sum(
                n for k, n in st.items() if k.startswith("k1_replayed."))
        out.append(got)
    assert out[0][0] == 0
    same_solve(*out)


@pytest.mark.cuda
def test_ensemble_with_kkt_graphs_is_the_eager_ensemble(on_card):
    """A 4-lane 40-segment CartPole ensemble whose lanes climb different
    numbers of rungs: replayed and eager, bitwise equal, with as many
    factorizations and K1 launches."""
    out = []
    for eager in (False, True):
        p = _card_problem("cartpole")
        if eager:
            p.optimizer.kkt._kkt_graphs = None
        got, st = ensemble(p, starts(p, 4, 0.05))
        assert climbs_differ(got)
        assert st["kkt_eager" if eager else "kkt_replays"] == \
            st["iterations"]
        assert (st["k1_replayed"] > 0) != eager
        assert all(int(k.split(".")[1].split("x")[0]) % 4 == 0
                   for k in st if k.startswith("k1_replayed."))
        out.append((got, st))
    (a, sa), (b, sb) = out
    for k in ("x", "flags", "iters", "objs", "infos", "lamE", "lamI", "s"):
        assert np.array_equal(a[k], b[k]), k
    assert (sa["factorizations"], sa["k1_launches"]) == \
        (sb["factorizations"], sb["k1_launches"])
