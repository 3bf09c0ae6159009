"""Multi-process execution on `torch.distributed`, and the meshes that lay
one problem's segment chain, or an ensemble's scenario axis, over ranks.

Port of `asset_asrl_tpu/distributed.py`.  Where the JAX package sees every
device of every process through `jax.distributed` and shards over a
`jax.sharding.Mesh`, the port runs one process a rank and lays a mesh's
shards over the ranks in row-major order, `Mesh.local` consecutive
shards a rank.  A rank holds its shards along a leading lane axis of its
tensors (the counterpart of XLA's virtual devices in one process), so one
rank on one card can hold a whole (2, 4) mesh.  Only what the mesh's
collectives move crosses ranks: `Mesh.all_gather` and `Mesh.psum` run
through `torch.distributed` whenever a process group is initialized, a
one-rank group included (NCCL on the card, gloo on the CPU).

    import asset_asrl_torch as ast
    ast.distributed.initialize()            # torchrun's environment
    mesh = ast.distributed.host_chip_mesh(chips=4)
    phase.setKKTBackend("sharded", mesh=mesh)
    phase.optimize()                        # identical on every rank
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from . import config

__all__ = ["initialize", "is_initialized", "host_chip_mesh", "chain_mesh",
           "Mesh"]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Join the process group (idempotent): NCCL when `config.DEVICE` is
    CUDA, gloo on the CPU.  Arguments left out come from the environment
    `torchrun` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK), e.g. initialize("10.0.0.1:8476", num_processes=4,
    process_id=rank).  `local_device_ids` (an int or a list, first entry
    used; default LOCAL_RANK when set) picks this rank's card."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("initialize: give coordinator_address or set "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env.get("WORLD_SIZE", 1) if num_processes is None
                else num_processes)
    rank = int(env.get("RANK", 0) if process_id is None else process_id)
    if local_device_ids is None and "LOCAL_RANK" in env:
        local_device_ids = int(env["LOCAL_RANK"])
    if local_device_ids is not None and config.DEVICE.type == "cuda":
        ids = np.atleast_1d(local_device_ids).tolist()
        torch.cuda.set_device(int(ids[0]))
        config.use_device(f"cuda:{int(ids[0])}")
    backend = "nccl" if config.DEVICE.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)


def is_initialized():
    return dist.is_initialized()


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A named grid of shards laid over the ranks in row-major order.

    Mesh((2, 4), ("host", "chip")) is JAX's `Mesh(devices.reshape(2, 4),
    ("host", "chip"))`; the world size must divide its size, and rank r
    holds the `local` consecutive shards `shards`.  `shape` maps each
    axis name to its size, as JAX's `mesh.shape` does.  `calls` counts
    the collectives that went through `torch.distributed`."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(s) for s in np.atleast_1d(shape))
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} does not fit axes "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = int(np.prod(shape))
        self.world, self.rank = _world()
        if self.size % self.world:
            raise ValueError(f"a mesh of {self.size} shards cannot be laid "
                             f"over {self.world} ranks")
        self.local = self.size // self.world
        self.shards = range(self.rank * self.local,
                            (self.rank + 1) * self.local)
        self.calls = {"all_gather": 0, "psum": 0}
        self._groups = {}

    def __repr__(self):
        return (f"Mesh({self.shape}, world={self.world}, "
                f"rank={self.rank})")

    def coords(self):
        """(size, naxes) coordinates of every shard."""
        return np.stack(np.unravel_index(np.arange(self.size),
                                         tuple(self.shape.values())), 1)

    def _axes(self, axis):
        if axis is None:
            return tuple(self.axis_names)
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} "
                                 f"(axes {self.axis_names})")
        return axes

    def _group(self, axes):
        """The process group of the ranks whose shards differ from this
        rank's only along `axes` (None: the whole world), and its size.
        Every rank makes every such group, in one order."""
        if axes in self._groups:
            return self._groups[axes]
        keep = [i for i, n in enumerate(self.axis_names) if n not in axes]
        key = [tuple(c) for c in self.coords()[:, keep]]
        owner = np.arange(self.size) // self.local
        comp = list(range(self.world))           # union-find over ranks

        def find(r):
            while comp[r] != r:
                r = comp[r]
            return r
        first = {}
        for k, r in zip(key, owner):
            a, b = find(int(r)), find(first.setdefault(k, int(r)))
            comp[max(a, b)] = min(a, b)
        parts = {}
        for r in range(self.world):
            parts.setdefault(find(r), []).append(r)
        mine = parts[find(self.rank)]
        if len(mine) == self.world:
            out = (None, self.world)
        else:
            groups = {tuple(p): dist.new_group(p)
                      for _, p in sorted(parts.items())}
            out = (groups[tuple(mine)], len(mine))
        self._groups[axes] = out
        return out

    def _check_group(self):
        if not dist.is_initialized():
            if self.world != 1:
                raise RuntimeError("the mesh was made in a process group "
                                   "that is gone")
            return False
        if (dist.get_world_size(), dist.get_rank()) != (self.world,
                                                        self.rank):
            raise RuntimeError("the mesh was made before this process "
                               "group; make it again")
        return True

    def all_gather(self, x, axis=None):
        """x (n, ...) of this rank, concatenated along dim 0 with the x of
        the other ranks whose shards differ from this rank's only along
        `axis` (a name, a tuple of names, None for every axis), in rank
        order.  Without a process group (one process) it is x."""
        axes = self._axes(axis)
        if not self._check_group():
            return x
        group, n = self._group(axes)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        self.calls["all_gather"] += 1
        return out

    def psum(self, x, axis=None):
        """The sum of x over the ranks of `all_gather`'s group."""
        axes = self._axes(axis)
        if not self._check_group():
            return x
        group, _ = self._group(axes)
        out = x.clone()
        dist.all_reduce(out, group=group)
        self.calls["psum"] += 1
        return out

    def lanes(self, nlanes, axis):
        """The slice of a batch of `nlanes` split over `axis` (nlanes /
        shape[axis] lanes a position) that this rank holds: the positions
        along `axis` of its shards.  `all_gather(x, axis)` of each rank's
        slice is the whole batch."""
        n = self.shape[self._axes(axis)[0]]
        if nlanes % n:
            raise ValueError(f"{nlanes} lanes do not split over {n} "
                             f"positions of axis {axis!r}")
        i = self.axis_names.index(axis)
        pos = np.unique(self.coords()[list(self.shards), i])
        if pos[-1] - pos[0] + 1 != len(pos):
            raise ValueError(f"this rank's positions along {axis!r} are "
                             f"not contiguous")
        per = nlanes // n
        return slice(int(pos[0]) * per, (int(pos[-1]) + 1) * per)


def host_chip_mesh(host_axis="host", chip_axis="chip", chips=None):
    """(ranks, chips) mesh: a row is a rank, and each rank lays `chips`
    shards (default 1) along its lane axis.  Works in one process too
    (1 x chips)."""
    world, _ = _world()
    return Mesh((world, 1 if chips is None else int(chips)),
                (host_axis, chip_axis))


def chain_mesh(axis="seg", shards=None):
    """Flat 1-axis mesh of `shards` shards a rank (default 1) over every
    rank."""
    world, _ = _world()
    return Mesh((world * (1 if shards is None else int(shards)),), (axis,))
