"""Segment-axis sharded block-tridiagonal KKT (substructuring over a mesh).

Port of `asset_asrl_tpu/Solvers/kkt_sharded.py`.  The block backend
factors [T, B; B^T, C] by block cyclic reduction (`kkt_block.bcr_factor`).
Here the macro chain is cut into D shards of L consecutive macros.  Each
shard keeps its FIRST macro as its boundary representative and eliminates
its L-1 interior macros by a local BCR whose *extended border* is [global
border | own representative | next shard's representative] (bext =
b + 2W).  Only the (bext x bext) border Schur complements cross ranks,
through `Mesh.all_gather`; the reduced chain over the D representatives
plus the global border is factored redundantly by every rank.  The
hierarchical form adds one level: each host row of a ("host", "chip")
mesh eliminates its chips' representatives down to one, and only the
host-level Schur complements cross the host axis.

Where JAX runs the per-shard function under `shard_map`, a rank here holds
its shards along the lane axis: the local eliminations of all its shards,
for every solver lane, are the lanes of ONE `bcr_factor` call (B * local
lanes, lane = solver lane * local + shard), so every level of every shard
is one K1 launch.  Every tensor keeps the leading solver-lane axis of the
port's private KKT interface; a factor's per-shard leaves are (B, local,
...).  The solution blocks are gathered at the end of a solve, so every
rank holds the whole step, as JAX's global output array does.

Inertia is exact: the interior pivot counts are summed over ranks
(`Mesh.psum`) and added to the reduced chain's count (Sylvester's law
over the whole elimination); the padded identity blocks add only +1
pivots.  The sharded factor and solve run on assembled blocks, outside any
`torch.func` transform: collectives are neither differentiable nor
vmappable.
"""

from __future__ import annotations

import numpy as np
import torch

from .kkt_block import (BlockKKT, _zpad, bcr_backsub, bcr_factor,
                        bcr_reduce_rhs, bcr_solve)

__all__ = ["sharded_factor", "sharded_solve", "sharded_factor_hier",
           "sharded_solve_hier", "pad_chain", "ShardedBlockKKT"]


def pad_chain(diag, lower, B, C, D):
    """Pad the K-macro chain of every lane (diag (Bn, K, W, W), ...) to
    D*L macros, L = max(2, ceil(K/D)), with identity diagonal blocks
    (clean +1 pivots) and zero couplings.  Returns (diag, lower, B, C,
    L)."""
    Bn, K, W, _ = diag.shape
    L = max(2, -(-K // D))
    Kp = D * L
    if Kp != K:
        eye = torch.eye(W, dtype=diag.dtype, device=diag.device)
        diag = torch.cat([diag, eye.expand(Bn, Kp - K, W, W)], 1)
        lower = _zpad(lower, 0, Kp - K)
        B = _zpad(B, 0, Kp - K)
        # the padded region must not couple to the real chain
        keep = torch.arange(Kp, device=diag.device) < K - 1
        lower = torch.where(keep[None, :, None, None], lower, 0.0)
    return diag, lower, B, C, L


def _tree(fn, t):
    if isinstance(t, dict):
        return {k: _tree(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree(fn, v) for v in t)
    return fn(t)


def _split(fac, Bn):
    """Leaves (Bn*n, ...) -> (Bn, n, ...): the solver lane leads."""
    return _tree(lambda t: t.reshape((Bn, t.shape[0] // Bn)
                                      + tuple(t.shape[1:])), fac)


def _merge(fac):
    """Leaves (Bn, n, ...) -> (Bn*n, ...): one lane a shard (or host)."""
    return _tree(lambda t: t.reshape((t.shape[0] * t.shape[1],)
                                      + tuple(t.shape[2:])), fac)


def _gather(mesh, x, Bn, axis):
    """x (Bn*n, ...), n entries of this rank a solver lane, gathered over
    `axis` -> (Bn, N, ...) in mesh order."""
    x = x.reshape((Bn, x.shape[0] // Bn) + tuple(x.shape[1:]))
    return mesh.all_gather(x.transpose(0, 1).contiguous(),
                           axis).transpose(0, 1)


def _local(t, mesh, D):
    """This rank's shards of t (Bn, D*L, ...) -> (Bn*local, L, ...)."""
    Bn, L = t.shape[0], t.shape[1] // D
    s = mesh.shards
    t = t.reshape((Bn, D, L) + tuple(t.shape[2:]))[:, s.start:s.stop]
    return t.reshape((Bn * len(s), L) + tuple(t.shape[3:]))


def _ext_couplings(l):
    """Chain couplings of a shard's interior macros 1..L-1 and their two
    extended-border columns, from l (N, L, W, W), l[:, j] = K[j+1, j]
    (j = L-1: the coupling to the next shard's representative).  Returns
    (lower_i, own, nxt), each (N, L-1, W, W)."""
    L = l.shape[1]
    lower_i = _zpad(l[:, 1:L - 1], 0, 1)
    own = _zpad(l[:, 0:1], 0, L - 2)          # K[int 0, own rep]
    nxt = _zpad(l[:, L - 1:L].transpose(-1, -2), L - 2, 0)
    return lower_i, own, nxt


def _local_factor(diag, lower, B, mesh, D):
    """Level 0: eliminate the interior macros of this rank's shards, every
    shard of every solver lane a lane of one `bcr_factor`.  Returns (fac,
    neigs (Bn*local,), border Schur complements (Bn*local, bext, bext))."""
    W, b = diag.shape[-1], B.shape[-1]
    d, l, Bl = _local(diag, mesh, D), _local(lower, mesh, D), \
        _local(B, mesh, D)
    lower_i, own, nxt = _ext_couplings(l)
    C0 = d.new_zeros((d.shape[0], b + 2 * W, b + 2 * W))
    C0[:, b:b + W, b:b + W] = d[:, 0]
    C0[:, b:b + W, :b] = Bl[:, 0]
    C0[:, :b, b:b + W] = Bl[:, 0].transpose(-1, -2)
    fac, neigs = bcr_factor(d[:, 1:], lower_i,
                            torch.cat([Bl[:, 1:], own, nxt], -1), C0,
                            invert_border=False)
    return fac, neigs, fac.pop("C_schur")


def _reduced_chain(Cs, C, b, W):
    """The chain over the representatives from the gathered border Schur
    complements Cs (Bn, N, bext, bext): representative g also receives
    shard g-1's next-representative Schur updates; the border parts sum
    once over the shards.  Returns (diag, lower, B, C) of bcr_factor."""
    sh = _zpad(Cs[:, :-1, b + W:], 1, 0)
    return (Cs[:, :, b:b + W, b:b + W] + sh[..., b + W:],
            Cs[:, :, b + W:, b:b + W],
            Cs[:, :, b:b + W, :b] + sh[..., :b],
            C + Cs[:, :, :b, :b].sum(1))


def _reduced_rhs(red, rb, b, W):
    """The reduced chain's rhs from the gathered reduced border rhs red
    (Bn, N, bext), as `_reduced_chain` does for the matrix."""
    return (red[:, :, b:b + W] + _zpad(red[:, :-1, b + W:], 1, 0),
            rb + red[:, :, :b].sum(1))


def _own_next(y, rng):
    """Representatives rng and rng + 1 of y (Bn, N, W) (the one after the
    last is 0) -> two (Bn*len(rng), W)."""
    W = y.shape[-1]
    yp = _zpad(y, 0, 1)
    return (yp[:, rng.start:rng.stop].reshape(-1, W),
            yp[:, rng.start + 1:rng.stop + 1].reshape(-1, W))


def _back(fac_loc, stack, r_root, z, y_own, y_nxt, nloc):
    """Back-substitution of the local interiors given the border and the
    own/next representatives; returns the local blocks (N, L, W)."""
    z_ext = torch.cat([z.repeat_interleave(nloc, 0), y_own, y_nxt], -1)
    y_int = bcr_backsub(fac_loc, stack, r_root, z_ext)
    return torch.cat([y_own[:, None], y_int], 1)


def _reduce_local(fac_loc, r, b):
    """Level-0 forward sweep of this rank's shards r (N, L, W): (stack,
    root rhs (N, W), reduced extended-border rhs (N, bext))."""
    N, _, W = r.shape
    rb0 = torch.cat([r.new_zeros((N, b)), r[:, 0], r.new_zeros((N, W))],
                    -1)
    return bcr_reduce_rhs(fac_loc, r[:, 1:], rb0)


def _check_flat(mesh, D):
    if D != mesh.size:
        raise ValueError(f"a chain axis of {D} shards on a mesh of "
                         f"{mesh.size}: shard over the whole mesh")


def sharded_factor(diag, lower, B, C, mesh, axis="seg"):
    """Factor every lane's padded chain over `mesh[axis]`.

    diag/lower (Bn, D*L, W, W), B (Bn, D*L, W, b) (`pad_chain`), C
    (Bn, b, b).  Returns (fac, neigs (Bn,)): fac["loc"] holds this rank's
    shards' local factors (leaves (Bn, local, ...)), fac["red"] the
    reduced chain's factor, the same on every rank."""
    Bn, _, W, _ = diag.shape
    D = mesh.shape[axis]
    _check_flat(mesh, D)
    b = C.shape[-1]
    fac_loc, neigs_loc, Cs = _local_factor(diag, lower, B, mesh, D)
    Cs_all = _gather(mesh, Cs, Bn, axis)           # (Bn, D, bext, bext)
    neigs = mesh.psum(neigs_loc.view(Bn, -1).sum(1), axis)
    fac_red, neigs_red = bcr_factor(*_reduced_chain(Cs_all, C, b, W))
    return dict(loc=_split(fac_loc, Bn), red=fac_red), neigs + neigs_red


def sharded_solve(fac, rhs_blocks, rhs_border, mesh, axis="seg"):
    """Solve with a `sharded_factor` result: rhs_blocks (Bn, D*L, W)
    padded, rhs_border (Bn, b).  Returns (y (Bn, D*L, W), z (Bn, b)),
    whole on every rank."""
    Bn, Kp, W = rhs_blocks.shape
    D = mesh.shape[axis]
    b = rhs_border.shape[-1]
    fac_loc = _merge(fac["loc"])
    r = _local(rhs_blocks, mesh, D)
    stack, r_root, rb_red = _reduce_local(fac_loc, r, b)
    red = _gather(mesh, rb_red, Bn, axis)          # (Bn, D, bext)
    y_red, z = bcr_solve(fac["red"], *_reduced_rhs(red, rhs_border, b, W))
    y_own, y_nxt = _own_next(y_red, mesh.shards)
    y_l = _back(fac_loc, stack, r_root, z, y_own, y_nxt, mesh.local)
    return _gather(mesh, y_l, Bn, axis).reshape(Bn, Kp, W), z


def _hosts(mesh, axes):
    """(H, Dc, this rank's first host, its host count); a host row must
    lie on one rank (the rows of `host_chip_mesh` are ranks)."""
    hax, cax = axes
    if tuple(mesh.axis_names) != (hax, cax):
        raise ValueError(f"hierarchical axes {axes} must be the mesh's "
                         f"axes {mesh.axis_names}")
    H, Dc = mesh.shape[hax], mesh.shape[cax]
    if mesh.local % Dc:
        raise ValueError(f"{mesh.local} shards a rank split a host row of "
                         f"{Dc} chips over ranks")
    return H, Dc, mesh.shards.start // Dc, mesh.local // Dc


def sharded_factor_hier(diag, lower, B, C, mesh, axes=("host", "chip")):
    """Two-level substructuring over a (host, chip) mesh: each chip
    shard eliminates its interior macros, each host row gathers its chips'
    border Schur complements over the chip axis and eliminates the chip
    representatives down to one, and only the host-level complements are
    gathered over the host axis; the H-host chain is factored redundantly.
    Inputs as `sharded_factor`, padded with `pad_chain(..., D=H*Dc)`."""
    hax, cax = axes
    H, Dc, h0, Hl = _hosts(mesh, axes)
    Bn, _, W, _ = diag.shape
    b = C.shape[-1]
    bext = b + 2 * W
    fac_loc, neigs_loc, Cs = _local_factor(diag, lower, B, mesh, H * Dc)

    # level 1: this rank's host rows reduce over their chip representatives
    Csc = _gather(mesh, Cs, Bn, cax).reshape(Bn * Hl, Dc, bext, bext)
    sh = Csc[:, :-1, b + W:]
    lower_i, own, nxt = _ext_couplings(Csc[:, :, b + W:, b:b + W])
    C0 = Csc.new_zeros((Bn * Hl, bext, bext))
    C0[:, :b, :b] = Csc[:, :, :b, :b].sum(1)
    C0[:, b:b + W, b:b + W] = Csc[:, 0, b:b + W, b:b + W]
    C0[:, b:b + W, :b] = Csc[:, 0, b:b + W, :b]
    C0[:, :b, b:b + W] = Csc[:, 0, :b, b:b + W]
    # chip Dc-1's Schur terms on the NEXT host's representative ride the
    # host-level complement to the top-level shift
    C0[:, b + W:, b + W:] = Csc[:, Dc - 1, b + W:, b + W:]
    C0[:, b + W:, :b] = Csc[:, Dc - 1, b + W:, :b]
    C0[:, :b, b + W:] = Csc[:, Dc - 1, :b, b + W:]
    fac_host, neigs_host = bcr_factor(
        Csc[:, 1:, b:b + W, b:b + W] + sh[..., b + W:], lower_i,
        torch.cat([Csc[:, 1:, b:b + W, :b] + sh[..., :b], own, nxt], -1),
        C0, invert_border=False)
    Cs2 = fac_host.pop("C_schur")

    # level 2: the host rows' complements over the host axis
    Csh = _gather(mesh, Cs2, Bn, hax)              # (Bn, H, bext, bext)
    fac_top, neigs_top = bcr_factor(*_reduced_chain(Csh, C, b, W))
    neigs = mesh.psum(neigs_loc.view(Bn, -1).sum(1)
                      + neigs_host.view(Bn, -1).sum(1), axes)
    return dict(loc=_split(fac_loc, Bn), host=_split(fac_host, Bn),
                red=fac_top), neigs + neigs_top


def sharded_solve_hier(fac, rhs_blocks, rhs_border, mesh,
                       axes=("host", "chip")):
    """Solve with a `sharded_factor_hier` result (a gather over the chip
    axis, then one over the host axis)."""
    hax, cax = axes
    H, Dc, h0, Hl = _hosts(mesh, axes)
    Bn, Kp, W = rhs_blocks.shape
    b = rhs_border.shape[-1]
    fac_loc, fac_host = _merge(fac["loc"]), _merge(fac["host"])
    r = _local(rhs_blocks, mesh, H * Dc)
    stack, r_root, rb_red = _reduce_local(fac_loc, r, b)
    # level 1: reduce onto each host row's representative
    allc = _gather(mesh, rb_red, Bn, cax).reshape(Bn * Hl, Dc, b + 2 * W)
    r_int_h = allc[:, 1:, b:b + W] + allc[:, :-1, b + W:]
    # the last chip's next-rep part belongs to the NEXT host's
    # representative: it rides the host-level border rhs
    rb_h = torch.cat([allc[:, :, :b].sum(1), allc[:, 0, b:b + W],
                      allc[:, Dc - 1, b + W:]], -1)
    stack_h, r_root_h, rb_red_h = bcr_reduce_rhs(fac_host, r_int_h, rb_h)
    # level 2
    red = _gather(mesh, rb_red_h, Bn, hax)         # (Bn, H, bext)
    y_top, z = bcr_solve(fac["red"], *_reduced_rhs(red, rhs_border, b, W))
    y_hown, y_hnxt = _own_next(y_top, range(h0, h0 + Hl))
    y_reps = torch.cat([_back(fac_host, stack_h, r_root_h, z,
                              y_hown, y_hnxt, Hl),
                        y_hnxt[:, None]], 1)       # (Bn*Hl, Dc+1, W)
    y_l = _back(fac_loc, stack, r_root, z, y_reps[:, :Dc].reshape(-1, W),
                y_reps[:, 1:].reshape(-1, W), mesh.local)
    return _gather(mesh, y_l, Bn, axes).reshape(Bn, Kp, W), z


class ShardedBlockKKT:
    """The block KKT with its factorization and solve sharded over a mesh
    (one problem's KKT distributed; border Schur complements exchanged by
    the mesh's collectives).

    Wraps a `BlockKKT`: the AD, the assembly and the inequality matvecs
    are its own, so the fused loop and the host loop run unchanged.  A
    1-axis mesh, or a 2-axis mesh with an axis of size 1, shards flat over
    its largest axis; a 2-axis ("host", "chip") mesh with both sizes >= 2
    runs the hierarchical elimination.  Its fused iterations run the
    block KKT eagerly, since its factor and solve run the mesh's
    collectives."""

    _kkt_graphs = None

    def __init__(self, base, mesh, axis="seg"):
        self._base = base
        self.mesh = mesh
        names = list(mesh.axis_names)
        sizes = [mesh.shape[n] for n in names]
        # the intra-level eliminations build (size-2)-length chains, so
        # hierarchical substructuring needs >= 2 on both axes
        self.hier = len(names) >= 2 and sizes[0] >= 2 and sizes[1] >= 2
        if self.hier:
            self.axes = tuple(names[:2])
            self.D = sizes[0] * sizes[1]
        else:
            if len(names) >= 2:
                axis = names[int(np.argmax(sizes[:2]))]
            self.axis = axis
            self.D = mesh.shape[axis]
        self.nlp, self.bs, self.device = base.nlp, base.bs, base.device
        self.ad_counts, self.kkt_counts = base.ad_counts, base.kkt_counts
        self._ls_graphs, self._ad_pool = base._ls_graphs, base._ad_pool
        self._perm = base._perm
        self._L = max(2, -(-base.bs.K // self.D))

    # family evaluation, assembly and the inequality matvecs: the base's
    def _eval_core(self, *a, **kw):
        return self._base._eval_core(*a, **kw)

    def _resid_impl(self, *a):
        return self._base._resid_impl(*a)

    def _blocks_impl(self, *a):
        return self._base._blocks_impl(*a)

    def _iq_matvec_impl(self, *a):
        return self._base._iq_matvec_impl(*a)

    def _iq_rmatvec_impl(self, *a):
        return self._base._iq_rmatvec_impl(*a)

    # the block backend's entry points, over this class's factor and solve
    eval_resid = BlockKKT.eval_resid
    factor = BlockKKT.factor
    solve = BlockKKT.solve
    iq_matvec = BlockKKT.iq_matvec
    iq_rmatvec = BlockKKT.iq_rmatvec
    _factor_impl = BlockKKT._factor_impl
    _solve_impl = BlockKKT._solve_impl

    def _factor_blocks_impl(self, blocks, delta, gammaE):
        """Regularize as the base does, pad to D*L macros and factor
        sharded; the padded identity blocks add +1 pivots only."""
        dg, lo, Bp, Cp, _ = pad_chain(
            *self._base._regularize(blocks, delta, gammaE), self.D)
        if self.hier:
            return sharded_factor_hier(dg, lo, Bp, Cp, self.mesh, self.axes)
        return sharded_factor(dg, lo, Bp, Cp, self.mesh, self.axis)

    def _block_solve(self, fac, rhs_blocks, rhs_border):
        K = rhs_blocks.shape[1]
        r = _zpad(rhs_blocks, 0, self.D * self._L - K)
        if self.hier:
            y, z = sharded_solve_hier(fac, r, rhs_border, self.mesh,
                                      self.axes)
        else:
            y, z = sharded_solve(fac, r, rhs_border, self.mesh, self.axis)
        return y[:, :K], z
