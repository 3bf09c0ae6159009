"""Dense KKT backend for problems whose structure does not fit the block
backend (or when it is asked for with `setKKTBackend("dense")`).

Port of `asset_asrl_tpu/Solvers/kkt_dense.py`.  Same API as
`kkt_block.BlockKKT`, but assembles the condensed system

    K = [ H + J_I^T Sigma~ J_I + delta I   J_E^T ]
        [ J_E                              -gammaE I ]

densely and factors it by a symmetric eigendecomposition
(`torch.linalg.eigh`, as the JAX package uses `jnp.linalg.eigh`): exact
inertia and a robust indefinite solve.  Inequalities are condensed as in
the block backend, so both give the same steps.
"""

from __future__ import annotations

import torch

from .. import config

__all__ = ["DenseKKT"]


class DenseKKT:

    def __init__(self, nlp):
        nlp.freeze()
        self.nlp = nlp
        self.device = nlp.device

    def eval_resid(self, x, lamE, lamI, sigma):
        obj, gradf, cE, cI, H, JE, JI = self.nlp.eval_kkt(x, lamE, lamI,
                                                          sigma)
        rd = gradf + JE.T @ lamE + JI.T @ lamI
        return obj, gradf, cE, cI, rd

    def factor(self, x, lamE, lamI, sigma, sig_tilde, delta, gammaE):
        nlp = self.nlp
        _, _, _, _, H, JE, JI = nlp.eval_kkt(x, lamE, lamI, sigma)
        n, mE = nlp.numPrimal, nlp.numEq
        eye = torch.eye(n, dtype=config.DTYPE, device=self.device)
        Hc = H + JI.T @ (sig_tilde[:, None] * JI) + float(delta) * eye
        K = torch.cat([
            torch.cat([Hc, JE.T], dim=1),
            torch.cat([JE, -float(gammaE) * torch.eye(
                mE, dtype=config.DTYPE, device=self.device)], dim=1)])
        w, V = torch.linalg.eigh(K)
        return dict(w=w, V=V, JI=JI), int((w < 0).sum())

    def solve(self, fac, rhs_x, rhs_E):
        w, V = fac["w"], fac["V"]
        r = torch.cat([rhs_x, rhs_E])
        sol = V @ ((V.T @ r) / w)
        n = self.nlp.numPrimal
        return sol[:n], sol[n:]

    def iq_matvec(self, fac, dx):
        return fac["JI"] @ dx

    def iq_rmatvec(self, fac, v):
        return fac["JI"].T @ v
