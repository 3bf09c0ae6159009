"""The port's meshes, scenario batches over a mesh and `Utils`:
`asset_asrl_torch.distributed` (`Mesh`, `chain_mesh`, `host_chip_mesh`)
in one process without a process group, `make_batched_step` and
`solve_ensemble` with a mesh against the same batch without one (the
mirror of `tests/test_parallel.py::test_sharded_mesh_determinism`), and
`Utils.Timer`, `Utils.Profiler` and `SoftwareInfo` on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import asset_asrl_tpu as jast
import asset_asrl_torch as tast
from asset_asrl_torch import parallel as tpar
from asset_asrl_torch.distributed import Mesh, chain_mesh, host_chip_mesh
from tests.test_torch_parallel import double_integrator

torch.set_num_threads(2)
# the port's tests run on the CPU, also on a machine with a card (the
# `cuda` tests place their tensors on the card themselves)
import asset_asrl_torch.config  # noqa: E402
asset_asrl_torch.config.use_device("cpu")


def test_meshes_without_a_process_group():
    """Without a group the world is one rank holding every shard; the
    helpers' shapes follow JAX's (host rows, chip columns); collectives
    hand the input back and count nothing."""
    assert not tast.distributed.is_initialized()
    m = host_chip_mesh(chips=4)
    assert m.axis_names == ("host", "chip")
    assert m.shape == {"host": 1, "chip": 4} and m.size == 4
    assert (m.world, m.rank, m.local, m.shards) == (1, 0, 4, range(4))
    assert chain_mesh().shape == {"seg": 1}
    assert chain_mesh(axis="scenario", shards=8).shape == {"scenario": 8}
    m = Mesh((2, 4), ("host", "chip"))
    assert m.coords()[5].tolist() == [1, 1]
    x = torch.arange(6.0).reshape(3, 2)
    assert m.all_gather(x, "chip") is x and m.psum(x) is x
    assert m.calls == {"all_gather": 0, "psum": 0}
    assert m.lanes(16, "host") == slice(0, 16)
    with pytest.raises(ValueError, match="no axis"):
        m.all_gather(x, "seg")
    with pytest.raises(ValueError, match="does not fit"):
        Mesh((2, 4), ("seg",))


def test_batched_step_over_a_mesh_is_deterministic():
    """8 lanes, 4 steps: the step over a ("scenario",) mesh of 8 shards
    equals the step without one (1e-12), as JAX's sharded step equals its
    unsharded one."""
    phase = double_integrator(tast)
    base = tpar.init_state(phase)
    rng = np.random.default_rng(1)
    xb = np.stack([base[0].numpy() + rng.normal(size=base[0].shape) * 1e-3
                   for _ in range(8)])

    def start():
        return (torch.tensor(xb),) + tuple(torch.stack([v] * 8)
                                           for v in base[1:])
    outs = []
    for mesh in (None, chain_mesh(axis="scenario", shards=8)):
        step = tpar.make_batched_step(phase, mesh=mesh)
        st = start()
        for _ in range(4):
            st, info = step(st)
        outs.append((st, info))
    for a, b in zip(outs[0][0] + (outs[0][1],), outs[1][0] + (outs[1][1],)):
        assert torch.allclose(a, b, atol=1e-12, rtol=0)


def test_ensemble_over_a_mesh_matches_unmeshed():
    """`solve_ensemble(mesh=)` over 4 shards of a ("scenario",) mesh
    returns the whole batch, equal to the unmeshed ensemble: flags and
    iterations exact, x to 1e-12."""
    phase = double_integrator(tast, 8)
    base = phase.makeSolverInput()
    rng = np.random.default_rng(5)
    perts = [rng.normal(size=base.shape) * 1e-3 for _ in range(4)]
    plain = tpar.solve_ensemble(phase, perturb_states=perts)
    meshed = tpar.solve_ensemble(
        phase, perturb_states=perts,
        mesh=chain_mesh(axis="scenario", shards=4))
    assert np.array_equal(plain["flags"], meshed["flags"])
    assert np.array_equal(plain["iters"], meshed["iters"])
    assert (plain["flags"] == 0).all()
    assert np.abs(plain["x"] - meshed["x"]).max() <= 1e-12


def test_utils_names_and_timer():
    """The port's Utils has the JAX package's names; Timer accumulates
    across start/stop pairs and resets."""
    names = [n for n in vars(jast.Utils) if not n.startswith("_")
             and callable(getattr(jast.Utils, n))
             and getattr(getattr(jast.Utils, n), "__module__", "")
             .startswith("asset_asrl_tpu")]
    assert sorted(names) == ["Profiler", "Timer", "get_core_count"]
    for n in names:
        assert hasattr(tast.Utils, n), n
    assert tast.Utils.get_core_count() >= 1
    t = tast.Utils.Timer()
    for _ in range(2):
        t.start()
        sum(range(10000))
        t.stop()
    first = t.count()
    assert first > 0
    t.stop()                    # a stop without a start adds nothing
    assert t.count() == first
    t.reset()
    assert t.count() == 0.0


def test_profiler_writes_a_chrome_trace(tmp_path):
    """`Utils.Profiler` on the CPU writes a Chrome trace into its logdir
    that names the operations run inside it, and sets `.elapsed`; the
    profile's `key_averages()` sums them."""
    a = torch.randn(64, 64, dtype=torch.float64)
    with tast.Utils.Profiler(tmp_path / "tr") as prof:
        (a @ a).sum()
    assert prof.elapsed > 0
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    with open(prof.trace_path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.profile.key_averages())


def test_profiler_sets_elapsed_when_the_trace_cannot_be_written(tmp_path):
    """JAX's contract: `.elapsed` is set on exit whatever happens; a trace
    that cannot be written raises rather than passing unnoticed."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    prof = tast.Utils.Profiler(blocker / "sub")
    with pytest.raises(OSError):
        with prof:
            torch.ones(3).sum()
    assert prof.elapsed is not None and prof.trace_path is None


def test_software_info_names_torch_and_the_devices(capsys):
    tast.SoftwareInfo()
    out = capsys.readouterr().out
    assert out.startswith("asset_asrl_torch ")
    assert f"torch {torch.__version__}" in out and "devices: " in out
