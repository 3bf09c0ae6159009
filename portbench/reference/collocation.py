"""One phase of Hermite-LGL collocation in plain PyTorch, for the plain
references: the solver vector's layout, the defects, the cardinal-only
quadrature and the linear control spline.  It imports nothing of the
program; the tables come from `hlgl.Scheme`.

The solver vector of a phase with N = S (cs - 1) + 1 nodes is N rows of
[states, controls], then t0 and tf.  Node times are uniform in each of the
S equal segments.  Functions take a batch: X is (B, n).
"""

import torch

from portbench.reference.hlgl import Scheme


class Phase:
    def __init__(self, cs, nsegs, nx, nu):
        self.cs, self.S, self.nx, self.nu = cs, nsegs, nx, nu
        self.N = nsegs * (cs - 1) + 1
        self.m = nx + nu
        self.n = self.N * self.m + 2
        self.scheme = Scheme(cs)

    def split(self, X):
        """(states (B, N, nx), controls (B, N, nu), t0 (B,), tf (B,))."""
        nodes = X[:, :self.N * self.m].reshape(-1, self.N, self.m)
        return (nodes[..., :self.nx], nodes[..., self.nx:],
                X[:, self.N * self.m], X[:, self.N * self.m + 1])

    def segments(self, v):
        """(B, N, k) node rows -> (B, S, cs, k), each segment's cardinals."""
        idx = torch.arange(self.S, device=v.device)[:, None] * (self.cs - 1) \
            + torch.arange(self.cs, device=v.device)[None, :]
        return v[:, idx]

    def _tab(self, a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    def node_times(self, t0, tf, taus):
        """(B, S, len(taus)) times of local positions `taus` in each
        segment."""
        h = (tf - t0) / self.S
        k = torch.arange(self.S, dtype=t0.dtype, device=t0.device)
        taus = self._tab(taus, t0)
        return t0[:, None, None] + h[:, None, None] * (
            k[None, :, None] + taus[None, None, :])

    def defects(self, X, rhs):
        """(B, S * (cs - 1) * nx) defects in segment order, then point,
        then state; rhs(x, u, t) takes and returns batched rows."""
        x, u, t0, tf = self.split(X)
        sc = self.scheme
        xs, us = self.segments(x), self.segments(u)       # (B, S, C, .)
        h = ((tf - t0) / self.S)[:, None, None, None]
        fs = h * rhs(xs, us, self.node_times(t0, tf, sc.cardinal)[..., None])
        tab = lambda a: self._tab(a, X)                   # noqa: E731
        xi = torch.einsum("ic,bscx->bsix", tab(sc.hx), xs) \
            + torch.einsum("ic,bscx->bsix", tab(sc.hf), fs)
        ui = torch.einsum("ic,bscu->bsiu", tab(sc.lu), us)
        dp = torch.einsum("ic,bscx->bsix", tab(sc.dhx), xs) \
            + torch.einsum("ic,bscx->bsix", tab(sc.dhf), fs)
        fi = h * rhs(xi, ui, self.node_times(t0, tf, sc.interior)[..., None])
        d = tab(sc.weight)[None, None, :, None] * (fi - dp)
        return d.reshape(X.shape[0], -1)

    def integral(self, X, g):
        """(B, S) each segment's cardinal-only quadrature of g(x, u, t)."""
        x, u, t0, tf = self.split(X)
        sc = self.scheme
        h = (tf - t0) / self.S
        vals = g(self.segments(x), self.segments(u),
                 self.node_times(t0, tf, sc.cardinal)[..., None])
        return h[:, None] * (vals @ self._tab(sc.quad, X))

    def linear_spline(self, X):
        """(B, S * (cs - 2) * nu): each inner cardinal control minus the
        straight line between its segment's end controls."""
        _, u, _, _ = self.split(X)
        us = self.segments(u)
        c = self._tab(self.scheme.cardinal[1:-1], X)[None, None, :, None]
        lin = (1.0 - c) * us[:, :, :1] + c * us[:, :, -1:]
        return (us[:, :, 1:-1] - lin).reshape(X.shape[0], -1)
