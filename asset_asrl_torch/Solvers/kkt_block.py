"""Block-tridiagonal KKT backend: structure analysis, gather-table assembly
and block cyclic reduction, in PyTorch.

Port of `asset_asrl_tpu/Solvers/kkt_block.py`, main path (the f64
factorization without refinement).  With the phase layout
[(x_i, u_i) per node | t0, tf, params], every defect / path-constraint row
couples a bounded window of consecutive nodes, so the reduced KKT
(inequalities condensed by slack/dual elimination) is

    K = [ T   B ]      T: symmetric block-tridiagonal over macro-blocks
        [ B^T C ]      B: coupling to a small dense border
                       C: border block (t0/tf/params + boundary rows)

Factorization is block cyclic reduction (BCR): log2(K) levels, each a
batch of dense eliminations of the odd macro-blocks.  Every block inverse
goes through kernel K1 (`cuda_kernels.gj_inverse_inertia`), whose pivot
signs give the inertia (Sylvester's law over the congruence) that drives
PSIOPT's perturbation ladder.

Assembly is deterministic: every KKT array (diag, lower, B, C) and every
gradient (rd, J_I^T v) is a static gather table over one value buffer plus
a sum; the few shared border columns are added by an indexed assignment
at distinct ids.

Everything from the family AD to the solve carries a leading lane axis:
B problems of one structure (a scenario batch) evaluate, assemble, factor
and solve together, every BCR level of every lane in one K1 launch.  One
problem is B = 1 of the same code; only the host loop's public methods
(`eval_resid`, `factor`, `solve`, `iq_matvec`, `iq_rmatvec`) take it
without the lane axis.

On a card the family AD is replayed from a CUDA graph: its eager
`torch.func` pass launches thousands of small kernels whose shapes depend
only on the lane count, the Hessian mode, `sigma` and the consts' shapes,
so `BlockKKT._eval_core` captures it once per such key and replays it
(`_ADGraph`).  A key whose capture fails (a host read inside a family)
stays eager for the life of the object; on the CPU every pass is eager.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..Utils import span
from .cuda_kernels import gj_inverse_inertia
from .nlp import _family_hess, _family_valjac

# profiler ranges (`Utils.span`); a family's are built in BlockKKT.__init__
_K1 = "asset.k1"
_BCR_FACTOR = "asset.kkt.bcr_factor"
_BCR_SOLVE = "asset.kkt.bcr_solve"


# ===========================================================================
# Structure analysis (numpy; copied from the JAX package)
# ===========================================================================

class BlockStructure:
    """Maps global unknowns (primal vars + eq multipliers) to
    (macro k, offset) or the border; precomputes scatter indices for
    assembling K directly in block form.

    Parameters
    ----------
    node_of_var : (n,) int array; node id per primal var, -1 = border var.
    eq_fams : list of (Vidx, rows, nout) per equality family (numpy).
    iq_fams : list of (Vidx, rows, nout) per inequality family.
    obj_fams : list of Vidx per objective family.
    """

    def __init__(self, numPrimal, numEq, numIq, node_of_var,
                 eq_fams, iq_fams, obj_fams):
        """eq_fams/iq_fams: [(Vidx, rows, jac_cm, hess_cm)], obj_fams:
        [(Vidx, jac_cm, hess_cm)] — (nin,) bool masks of the inputs the
        function's Jacobian / adjoint-Hessian actually touch (probed
        sparsity, the TPU analog of the reference's INPUT_DOMAIN tracking
        in `FunctionDomains.h`).  For inequalities hess_cm must include
        the slack-condensation coupling (all Jacobian-column pairs).

        Far couplings do NOT force a dense fallback (the reference's
        Pardiso handles arbitrary sparsity; our escape hatch is the dense
        border): an application whose *Jacobian* row spans non-adjacent
        macros puts that constraint row in the border, and an application
        whose *Hessian* couples non-adjacent macros (nonlinear
        front-to-back constraints, periodicity, long-range links) promotes
        its minority variables to the border so every remaining in-band
        entry couples adjacent macros only."""
        node_of_var = np.asarray(node_of_var, np.int64)
        self.n, self.mE, self.mI = numPrimal, numEq, numIq
        nnodes = int(node_of_var.max()) + 1

        def app_spans(Vidx, colmask, extra_excl=None):
            nds = node_of_var[Vidx]              # (napps, nin)
            valid = (nds >= 0) & colmask[None, :]
            if extra_excl is not None:
                valid &= ~extra_excl[Vidx]
            lo = np.where(valid, nds, np.iinfo(np.int64).max).min(axis=1)
            hi = np.where(valid, nds, -1).max(axis=1)
            return lo, hi

        # -------- macro sizing: max node window of any LOCAL application.
        # Apps spanning more than LOCAL_THR nodes (front-to-back rows,
        # periodicity, Accumulation-style couplings) are routed via the
        # border instead of inflating the macro size q.
        LOCAL_THR = max(2, nnodes // 4)
        max_span = 1
        for Vidx, rows, jcm, hcm in eq_fams + iq_fams:
            lo, hi = app_spans(Vidx, jcm | hcm)
            if len(lo):
                sp = np.where(hi >= 0, hi - lo + 1, 1)
                sp = sp[sp <= LOCAL_THR]
                if len(sp):
                    max_span = max(max_span, int(sp.max()))
        for Vidx, jcm, hcm in obj_fams:
            lo, hi = app_spans(Vidx, hcm)
            if len(lo):
                sp = np.where(hi >= 0, hi - lo + 1, 1)
                sp = sp[sp <= LOCAL_THR]
                if len(sp):
                    max_span = max(max_span, int(sp.max()))

        self.q = max(1, max_span - 1)            # nodes per macro
        self.K = max(1, -(-nnodes // self.q))    # number of macros
        macro_of_node = np.minimum(np.arange(nnodes) // self.q, self.K - 1)

        # -------- border promotion of far-coupled Hessian variables -------
        # For every app whose Hessian couples non-adjacent macros, keep the
        # adjacent macro pair holding the most of its variables and promote
        # the rest to the border (their rows/cols land in B / C).
        promote = np.zeros(numPrimal, bool)
        hess_groups = [(V, h) for V, r, j, h in eq_fams + iq_fams] \
            + [(V, h) for V, j, h in obj_fams]
        for Vidx, hcm in hess_groups:
            if not hcm.any() or not len(Vidx):
                continue
            lo, hi = app_spans(Vidx, hcm)
            far = (hi >= 0) & (macro_of_node[np.maximum(hi, 0)]
                               - macro_of_node[np.clip(lo, 0, nnodes - 1)]
                               > 1)
            for a in np.where(far)[0]:
                cols = np.where(hcm & (node_of_var[Vidx[a]] >= 0))[0]
                vids = Vidx[a][cols]
                macs = macro_of_node[node_of_var[vids]]
                # best adjacent macro pair by member count
                cnt = np.bincount(macs, minlength=self.K)
                pair = cnt + np.append(cnt[1:], 0)    # count in {m, m+1}
                m0 = int(np.argmax(pair))
                keep = (macs == m0) | (macs == m0 + 1)
                promote[vids[~keep]] = True

        # -------- unknown -> (macro, slot) assignment ----------------------
        # vars first, then eq rows, macro by macro
        var_macro = np.where((node_of_var >= 0) & ~promote,
                             macro_of_node[np.maximum(node_of_var, 0)], -1)

        # eq row macro: middle node of the app's banded-jacobian span
        # (border if no banded nodes or the span crosses >2 macros)
        row_macro = np.full(numEq, -1, np.int64)
        for Vidx, rows, jcm, hcm in eq_fams:
            lo, hi = app_spans(Vidx, jcm, extra_excl=promote)
            for a in range(Vidx.shape[0]):
                if hi[a] < 0:
                    continue  # border row (params/promoted only)
                mlo = macro_of_node[lo[a]]
                mhi = macro_of_node[hi[a]]
                if mhi - mlo > 1:
                    continue  # spans too far even after promotion: border
                row_macro[rows[a]] = mlo if (hi[a] - lo[a] == 0) else \
                    macro_of_node[(lo[a] + hi[a]) // 2]

        # slots
        self.var_slot = np.zeros(numPrimal, np.int64)
        self.row_slot = np.zeros(numEq, np.int64)
        counts = np.zeros(self.K, np.int64)
        border_count = 0
        # assign var slots macro-major preserving var order
        for k in range(self.K):
            idx = np.where(var_macro == k)[0]
            self.var_slot[idx] = counts[k] + np.arange(len(idx))
            counts[k] += len(idx)
        bidx = np.where(var_macro < 0)[0]
        self.border_var_slot = {int(v): border_count + i
                                for i, v in enumerate(bidx)}
        border_count += len(bidx)
        self.nborder_vars = len(bidx)
        for k in range(self.K):
            idx = np.where(row_macro == k)[0]
            self.row_slot[idx] = counts[k] + np.arange(len(idx))
            counts[k] += len(idx)
        bre = np.where(row_macro < 0)[0]
        self.border_row_slot = {int(r): border_count + i
                                for i, r in enumerate(bre)}
        border_count += len(bre)
        self.b = border_count
        self.W = int(counts.max()) if self.K else 0
        self.counts = counts
        self.var_macro = var_macro
        self.row_macro = row_macro
        self.macro_of_node = macro_of_node

        # global unknown id -> (macro, slot) arrays for vars and rows
        self._uvar_macro = var_macro
        self._uvar_slot = np.where(
            var_macro >= 0, self.var_slot,
            np.array([self.border_var_slot.get(int(v), 0)
                      for v in range(numPrimal)]))
        self._urow_macro = row_macro
        self._urow_slot = np.where(
            row_macro >= 0, self.row_slot,
            np.array([self.border_row_slot.get(int(r), 0)
                      for r in range(numEq)]))

        # number of negative eigenvalues expected: mE (+mI condensed)
        self.target_neigs = numEq

    # ------------------------------------------------------------- targets
    def jac_targets(self, Vidx, rows, nz=None):
        """Scatter targets for a constraint-Jacobian batch.

        Input J values are ordered (app, r, c) flattened.  Each value lands
        symmetrically in K; returns dict arr_name -> (src_flat, tgt_flat)
        covering both triangles (diag/C get two placements per value, the
        lower/B arrays hold one canonical triangle).  nz: (nout, nin) bool
        sparsity mask — structurally-zero entries are pruned.
        """
        napps, nout = rows.shape
        nin = Vidx.shape[1]
        W, b = self.W, self.b
        src = np.arange(napps * nout * nin).reshape(napps, nout, nin)
        if nz is not None:
            src = np.where(nz[None, :, :], src, -1)
        rmac = self._urow_macro[rows][:, :, None] + np.zeros((1, 1, nin),
                                                            np.int64)
        rslot = self._urow_slot[rows][:, :, None] + np.zeros((1, 1, nin),
                                                             np.int64)
        cmac = self._uvar_macro[Vidx][:, None, :] + np.zeros((1, nout, 1),
                                                             np.int64)
        cslot = self._uvar_slot[Vidx][:, None, :] + np.zeros((1, nout, 1),
                                                              np.int64)
        return self._classify(src, rmac, rslot, cmac, cslot, sym_from_one=True)

    def hess_targets(self, Vidx, nz=None):
        """Scatter targets for a symmetric-Hessian batch ordered
        (app, a, b): each value lands once at its natural position; upper
        inter-macro entries are skipped (covered by their transposed
        partner).  nz: (nin, nin) bool sparsity mask."""
        napps, nin = Vidx.shape
        src = np.arange(napps * nin * nin).reshape(napps, nin, nin)
        if nz is not None:
            src = np.where(nz[None, :, :], src, -1)
        amac = self._uvar_macro[Vidx][:, :, None] + np.zeros((1, 1, nin),
                                                             np.int64)
        aslot = self._uvar_slot[Vidx][:, :, None] + np.zeros((1, 1, nin),
                                                              np.int64)
        bmac = self._uvar_macro[Vidx][:, None, :] + np.zeros((1, nin, 1),
                                                             np.int64)
        bslot = self._uvar_slot[Vidx][:, None, :] + np.zeros((1, nin, 1),
                                                              np.int64)
        return self._classify(src, amac, aslot, bmac, bslot,
                              sym_from_one=False)

    def _classify(self, src, rmac, rslot, cmac, cslot, sym_from_one):
        W, b, K = self.W, self.b, self.K
        src = src.ravel()
        rmac, rslot = rmac.ravel(), rslot.ravel()
        cmac, cslot = cmac.ravel(), cslot.ravel()
        keep = src >= 0
        src, rmac, rslot = src[keep], rmac[keep], rslot[keep]
        cmac, cslot = cmac[keep], cslot[keep]
        rb = rmac < 0
        cb = cmac < 0
        out = {}

        both = (~rb) & (~cb)
        same = both & (rmac == cmac)
        low = both & (rmac == cmac + 1)
        upp = both & (cmac == rmac + 1)
        bad = both & (np.abs(rmac - cmac) > 1)
        if np.any(bad):
            raise ValueError(
                "KKT structure violation: entry couples non-adjacent "
                "macro-blocks; increase macro size q")

        def flatD(k, i, j):
            return k * W * W + i * W + j

        if sym_from_one:
            # J value -> both (r,c) and (c,r)
            s = np.concatenate([src[same], src[same]])
            t = np.concatenate([flatD(rmac[same], rslot[same], cslot[same]),
                                flatD(rmac[same], cslot[same], rslot[same])])
            out["diag"] = (s, t)
            s = np.concatenate([src[low], src[upp]])
            t = np.concatenate([
                flatD(cmac[low], rslot[low], cslot[low]),
                flatD(rmac[upp], cslot[upp], rslot[upp])])
            out["lower"] = (s, t)
            # banded x border
            rbb = (~rb) & cb
            brb = rb & (~cb)
            s = np.concatenate([src[rbb], src[brb]])
            t = np.concatenate([
                rmac[rbb] * W * b + rslot[rbb] * b + cslot[rbb],
                cmac[brb] * W * b + cslot[brb] * b + rslot[brb]])
            out["B"] = (s, t)
            bb = rb & cb
            s = np.concatenate([src[bb], src[bb]])
            t = np.concatenate([rslot[bb] * b + cslot[bb],
                                cslot[bb] * b + rslot[bb]])
            out["C"] = (s, t)
        else:
            out["diag"] = (src[same],
                           flatD(rmac[same], rslot[same], cslot[same]))
            out["lower"] = (src[low],
                            flatD(cmac[low], rslot[low], cslot[low]))
            rbb = (~rb) & cb
            out["B"] = (src[rbb],
                        rmac[rbb] * W * b + rslot[rbb] * b + cslot[rbb])
            bb = rb & cb
            out["C"] = (src[bb], rslot[bb] * b + cslot[bb])
        return {k: (np.asarray(s, np.int64), np.asarray(t, np.int64))
                for k, (s, t) in out.items()}

    def rhs_perm(self):
        """Flat positions of (vars ++ eq rows) in the block rhs layout:
        banded unknown -> k*W + slot, border unknown -> K*W + border_slot."""
        n, mE = self.n, self.mE
        pos = np.empty(n + mE, np.int64)
        vm, vs = self._uvar_macro, self._uvar_slot
        pos[:n] = np.where(vm >= 0, vm * self.W + vs, self.K * self.W + vs)
        rm, rs = self._urow_macro, self._urow_slot
        pos[n:] = np.where(rm >= 0, rm * self.W + rs, self.K * self.W + rs)
        return pos



# ===========================================================================
# BCR factorization of [T, B; B^T, C]
# ===========================================================================

def _zpad(x, before, after):
    """Pad axis 1 (the chain axis, after the batch axis) of x with
    `before` / `after` zero slices."""
    parts = []
    if before > 0:
        parts.append(x.new_zeros((x.shape[0], before) + tuple(x.shape[2:])))
    parts.append(x)
    if after > 0:
        parts.append(x.new_zeros((x.shape[0], after) + tuple(x.shape[2:])))
    return torch.cat(parts, 1) if len(parts) > 1 else x


def _mv(A, v):
    """(..., a, b) @ (..., b) -> (..., a).

    One lane's root and border products, (1, a, b), go through a plain
    matrix-vector product, several lanes' through one batched product.
    Each single form tried breaks a host-loop parity the plain product
    keeps: a batched product of one matrix moves the auto-scaled
    three-phase Goddard problem (CPU) from the JAX package's 26 iterations
    to 32, and a product and a sum over the last axis moves Delta III at
    10,004 nodes (H100) from 53 iterations to 44.  So an ensemble lane
    may round unlike its solo solve (`test_torch_parallel.py` bounds
    it)."""
    if A.dim() == 3 and A.shape[0] == 1:
        return (A[0] @ v[0])[None]
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def _mv_shared(A, v):
    """(B, K, a, b) @ (B, b) -> (B, K, a): each lane's K matrices times
    that lane's one vector (one lane: the plain product, as `_mv`)."""
    if A.shape[0] == 1:
        return (A[0] @ v[0])[None]
    return (A @ v[:, None, :, None]).squeeze(-1)


def _mv_t(A, v):
    """(..., b, a)^T @ (..., b) -> (..., a) (one lane: as `_mv`)."""
    if A.dim() == 3 and A.shape[0] == 1:
        return (A[0].T @ v[0])[None]
    return (A.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def _inv_sym(D):
    """Batched symmetric inverse + negative-pivot inertia count, through
    kernel K1.

    D is (B, Ke, W, W): every block of every lane goes through ONE K1
    launch; the bad-pivot count is summed over the Ke axis, one count per
    lane.  Singular or non-finite pivots count as inertia failures, so
    the solver's perturbation ladder engages; with delta/gamma
    regularization every macro block is quasi-definite and elimination is
    clean.  The count is a pure sign count (no relative pivot threshold),
    as on the JAX package's CPU path.  K1 counts the bad pivots per block
    and zeroes the non-finite entries of the inverse itself; the sums stay
    on the device."""
    with span(_K1):
        lead, W = D.shape[:-2], D.shape[-1]
        Dinv, _, nbad = gj_inverse_inertia(D.reshape(-1, W, W).contiguous())
        return Dinv.reshape(D.shape), nbad.view(lead).sum(-1)


def bcr_factor(diag, lower, Bmat, C, invert_border=True):
    """Compacted block cyclic reduction of [T, B; B^T, C] for a batch of
    B problems of one structure (a leading lane axis; one problem is
    B = 1).

    diag (B,K,W,W) symmetric; lower (B,K,W,W) with lower[:, k] =
    K[k+1,k] (entry K-1 unused); Bmat (B,K,W,b); C (B,b,b).  Each level
    halves the chain: the odd blocks of every lane are inverted as one
    batch (one K1 launch) and eliminated with two batched products.
    Returns (fac, neigs): the factor and the count of negative eigenvalues
    of each lane's matrix (B,).  invert_border=False (substructuring,
    `kkt_sharded`) stops at the border's Schur complement: the factor
    holds `C_schur` (B,b,b) instead of `Cinv`, and neigs counts the
    chain's pivots only."""
    with span(_BCR_FACTOR):
        Bn, K, W, _ = diag.shape
        b = C.shape[-1]
        neigs = torch.zeros((Bn,), dtype=torch.int64, device=diag.device)
        levels = []
        d, l, B = diag, lower, Bmat
        while d.shape[1] > 1:
            Ka = d.shape[1]
            Ke = Ka // 2
            Kn = Ka - Ke
            dpad = _zpad(d, 0, 1)
            lpad = _zpad(l, 0, 2)
            Bpad = _zpad(B, 0, 1)
            d_even = dpad[:, 0::2][:, :Kn]
            d_odd = dpad[:, 1::2][:, :Ke]
            L_le = lpad[:, 0::2][:, :Ke]          # K[2i+1, 2i]
            L_er = lpad[:, 1::2][:, :Ke]          # K[2i+2, 2i+1]
            B_even = Bpad[:, 0::2][:, :Kn]
            B_odd = Bpad[:, 1::2][:, :Ke]

            Dinv, neg = _inv_sym(d_odd)
            neigs = neigs + neg
            levels.append(dict(Dinv=Dinv, L_le=L_le, L_er=L_er, B_odd=B_odd))

            def overlap2(base, at0, at1):
                """base (B,Kn,...) - at0 placed at [0:Ke] - at1 placed at
                [1:Ke+1] (entries beyond Kn dropped)."""
                out = base - _zpad(at0[:, :Kn], 0, Kn - min(Ke, Kn))
                a1 = at1[:, :Kn - 1]
                return out - _zpad(a1, 1, Kn - 1 - a1.shape[1])

            # Packed elimination: every Schur update of the level comes from
            # two batched products.  X = [L_le^T; L_er; B_odd^T] (Ke, 2W+b, W),
            # Z = (X Dinv) [L_le | L_er^T | B_odd]:
            #   Z[:W,  :W]   = L_le^T Dinv L_le   (even-diag update, left)
            #   Z[W:2W,:W]   = L_er  Dinv L_le    (-l_new)
            #   Z[W:2W,W:2W] = L_er  Dinv L_er^T  (even-diag update, right)
            #   Z[:W,  2W:]  = L_le^T Dinv B_odd  (B update, left)
            #   Z[W:2W,2W:]  = L_er  Dinv B_odd   (B update, right)
            #   Z[2W:, 2W:]  = B_odd^T Dinv B_odd (border C update)
            X = torch.cat([L_le.transpose(-1, -2), L_er,
                           B_odd.transpose(-1, -2)], dim=2)
            R = torch.cat([L_le, L_er.transpose(-1, -2), B_odd], dim=3)
            Z = (X @ Dinv) @ R
            d_new = overlap2(d_even, Z[:, :, :W, :W],
                             Z[:, :, W:2 * W, W:2 * W])
            if b > 0:
                B_new = overlap2(B_even, Z[:, :, :W, 2 * W:],
                                 Z[:, :, W:2 * W, 2 * W:])
                C = C - Z[:, :, 2 * W:, 2 * W:].sum(1)
            else:
                B_new = B_even

            l_new = -Z[:, :, W:2 * W, :W]
            if Kn > 1:
                l_new = l_new[:, :Kn - 1] if l_new.shape[1] >= Kn - 1 else \
                    _zpad(l_new, 0, Kn - 1 - l_new.shape[1])
            else:
                l_new = l.new_zeros((Bn, 1, W, W))
            d, l, B = d_new, l_new, B_new

        # final single block + border Schur complement (the border of every
        # lane in one K1 launch)
        Dinv0, neg0 = _inv_sym(d)
        neigs = neigs + neg0
        D0inv = Dinv0[:, 0]
        B0 = B[:, 0]
        C_schur = C - B0.transpose(-1, -2) @ D0inv @ B0
        if not invert_border:
            return dict(levels=levels, D0inv=D0inv, B0=B0,
                        C_schur=C_schur), neigs
        if b > 0:
            Cinv1, negC = _inv_sym(C_schur[:, None])
            neigs = neigs + negC
            Cinv = Cinv1[:, 0]
        else:
            Cinv = diag.new_zeros((Bn, 0, 0))
        return dict(levels=levels, D0inv=D0inv, B0=B0, Cinv=Cinv), neigs


def bcr_reduce_rhs(fac, rhs_blocks, rhs_border):
    """Forward sweep: reduce the banded rhs (B,K,W) onto the root block +
    border.  Returns (stack of eliminated odd rhs per level, root rhs
    (B,W), reduced border rhs (B,b))."""
    r = rhs_blocks
    rb = rhs_border
    stack = []
    for lev in fac["levels"]:
        Ka = r.shape[1]
        Ke = lev["Dinv"].shape[1]
        Kn = Ka - Ke
        rpad = _zpad(r, 0, 1)
        r_even = rpad[:, 0::2][:, :Kn]
        r_odd = rpad[:, 1::2][:, :Ke]
        stack.append(r_odd)
        t = _mv(lev["Dinv"], r_odd)
        a0 = _mv_t(lev["L_le"], t)[:, :Kn]
        a1 = _mv(lev["L_er"], t)[:, :Kn - 1]
        r = r_even - _zpad(a0, 0, Kn - a0.shape[1]) \
            - _zpad(a1, 1, Kn - 1 - a1.shape[1])
        rb = rb - (lev["B_odd"] * t[..., None]).sum((1, 2))
    rb = rb - _mv_t(fac["B0"], _mv(fac["D0inv"], r[:, 0]))
    return stack, r[:, 0], rb


def bcr_backsub(fac, stack, r_root, z):
    """Back-substitution with a given border solution z (B,b)."""
    Bn, W = r_root.shape
    y = _mv(fac["D0inv"], r_root - _mv(fac["B0"], z))[:, None]
    for lev, r_odd in zip(reversed(fac["levels"]), reversed(stack)):
        Ke = lev["Dinv"].shape[1]
        Kn = y.shape[1]
        Ka = Kn + Ke
        ypad = _zpad(y, 0, 1)
        contrib = r_odd - _mv(lev["L_le"], y[:, :Ke]) \
            - _mv_t(lev["L_er"], ypad[:, 1:Ke + 1])
        if z.shape[1] > 0:
            contrib = contrib - _mv_shared(lev["B_odd"], z)
        y_odd = _mv(lev["Dinv"], contrib)
        # interleave even/odd without scatter: stack + reshape
        y_odd_p = _zpad(y_odd, 0, Kn - Ke)
        y = torch.stack([y, y_odd_p], dim=2).reshape(Bn, 2 * Kn, W)[:, :Ka]
    return y


def bcr_solve(fac, rhs_blocks, rhs_border):
    """Solve [T,B;B^T,C][y;z]=[r;rb] with the bcr_factor output, for every
    lane: rhs_blocks (B,K,W), rhs_border (B,b)."""
    with span(_BCR_SOLVE):
        stack, r_root, rb = bcr_reduce_rhs(fac, rhs_blocks, rhs_border)
        z = _mv(fac["Cinv"], rb) if fac["Cinv"].shape[-1] > 0 else rb
        y = bcr_backsub(fac, stack, r_root, z)
        return y, z


# ===========================================================================
# Gather tables
# ===========================================================================

def _gather_rows(pairs, zero_slot):
    """Invert (src, tgt) pairs into a compact gather table.

    Returns (targets (T,), table (T, width)): row t lists the value-buffer
    positions that sum into target `targets[t]`, in source order; unused
    slots point at `zero_slot` (a zero appended to the buffer)."""
    if not pairs:
        return np.zeros(0, np.int64), np.full((0, 1), zero_slot, np.int64)
    src = np.concatenate([np.asarray(s, np.int64) for s, t in pairs])
    tgt = np.concatenate([np.asarray(t, np.int64) for s, t in pairs])
    order = np.argsort(tgt, kind="stable")
    src, tgt = src[order], tgt[order]
    targets, first, counts = np.unique(tgt, return_index=True,
                                       return_counts=True)
    width = int(counts.max()) if len(counts) else 1
    row = np.repeat(np.arange(len(targets)), counts)
    slot = np.arange(len(tgt)) - first[row]
    table = np.full((len(targets), max(width, 1)), zero_slot, np.int64)
    table[row, slot] = src
    return targets, table


def _build_table(pairs, size, zero_slot):
    """Full gather table (size, width) over every target (the JAX
    package's `_build_table` layout, without an overflow scatter)."""
    targets, rows = _gather_rows(pairs, zero_slot)
    table = np.full((size, rows.shape[1]), zero_slot, np.int64)
    table[targets] = rows
    return table


def _grad_plan(fams, n, uvar_macro):
    """Gather plan that sums per-family (napps, nin) arrays into an
    n-vector.  Border columns that every application of a family shares
    (t0, tf, parameters) are summed over the applications and added at
    their distinct ids; everything else goes through one (n, width) table
    into the concatenated flat arrays (+ a zero slot)."""
    goff = 0
    gpairs = []
    border = []
    for i, fam in enumerate(fams):
        Vidx = fam["Vidx"]
        napps, nin = fam["napps"], fam["nin"]
        bcol = uvar_macro[Vidx] < 0
        uniform = np.all(bcol == bcol[0:1], axis=0)
        src = goff + np.arange(napps * nin).reshape(napps, nin)
        bc = np.where(uniform & bcol[0])[0] if napps else \
            np.zeros(0, np.int64)
        keep = np.ones(nin, bool)
        # shared border columns must name distinct ids (one index_add call
        # per family; a link may gather the same parameter twice)
        if len(bc) and napps and np.all(Vidx[:, bc] == Vidx[0:1, bc]) \
                and len(np.unique(Vidx[0, bc])) == len(bc):
            border.append((i, bc, Vidx[0, bc]))
            keep[bc] = False
        gpairs.append((src[:, keep].ravel(), Vidx[:, keep].ravel()))
        goff += napps * nin
    return _build_table(gpairs, n, goff), border


def _apply_grad_plan(table, border, parts, nlanes):
    """Sum per-family (B, napps, nin) arrays into (B, n) through the plan.
    The shared border columns land at distinct ids, so an indexed
    assignment adds each exactly once (no index_add, deterministic)."""
    dev = table.device
    buf = torch.cat([p.reshape(nlanes, -1) for p in parts]
                    + [torch.zeros((nlanes, 1), dtype=config.DTYPE,
                                   device=dev)], 1)
    out = buf[:, table].sum(-1)
    for i, cols, ids in border:
        out[:, ids] = out[:, ids] + parts[i][:, :, cols].sum(1)
    return out


def _lanes(x):
    """(B, napps, ...) -> (B*napps, ...): every lane's applications as
    rows of one family batch."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


# ===========================================================================
# The family AD as a CUDA graph
# ===========================================================================

def _ad_inputs(x, lamE, lamI, consts):
    """Every tensor input of one family-AD pass, in a fixed order."""
    return [x, lamE, lamI] + [c for group in consts for c in group]


def _copy_out(tree):
    """A copy of every tensor of `tree` (tuples, lists, dicts, None)."""
    if isinstance(tree, dict):
        return {k: _copy_out(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_out(v) for v in tree)
    return None if tree is None else tree.clone()


class _ADGraph:
    """One family-AD pass (`BlockKKT._eval_eager`) captured as a CUDA graph
    over static input buffers.  A call copies its inputs into them,
    replays, and returns copies of the static outputs, so no tensor a
    caller keeps (the factor's `iq_jx`) is overwritten by the next
    replay.  The graphs of one BlockKKT share one memory pool: a later
    capture may place its outputs in an earlier graph's scratch memory,
    which that graph's replays overwrite, and the copies taken right
    after each replay make that harmless."""

    def __init__(self, kkt, x, lamE, lamI, sigma, consts, want_hess):
        def static(t):
            return t.clone(memory_format=torch.contiguous_format)
        sx, slE, slI = static(x), static(lamE), static(lamI)
        sconsts = tuple(tuple(static(c) for c in group) for group in consts)
        self.inputs = _ad_inputs(sx, slE, slI, sconsts)

        def body():
            return kkt._eval_eager(sx, slE, slI, sigma, sconsts, want_hess)

        # warm-up on a side stream (lazy caches, library handles), then
        # the capture
        main = torch.cuda.current_stream(x.device)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            body()
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=kkt._ad_pool):
            self.outputs = body()

    def __call__(self, x, lamE, lamI, consts):
        for dst, src in zip(self.inputs, _ad_inputs(x, lamE, lamI, consts)):
            dst.copy_(src)
        self.graph.replay()
        return _copy_out(self.outputs)


# ===========================================================================
# BlockKKT
# ===========================================================================

class BlockKKT:
    """KKT provider over the block-tridiagonal+border structure.

    One problem (the host loop's interface):
      eval_resid(x, lamE, lamI, sigma) -> (obj, rd, cE, cI, rd)
      factor(x, lamE, lamI, sigma, sig_tilde, delta, gammaE) -> (fac, neigs)
      solve(fac, rhs_x, rhs_E) -> (dx, dlamE)
      iq_matvec(fac, dx) -> J_I dx ;  iq_rmatvec(fac, v) -> J_I^T v

    The functional pieces the fused loop and the ensembles call, on state
    with a leading lane axis (x (B, n), ...): `_eval_core` (one vmapped
    f/J/adjoint-H pass over every family), `_resid_impl`, `_blocks_impl`
    (gather-table assembly of diag, lower, B, C), `_factor_blocks_impl`
    (regularize + block cyclic reduction, delta per lane), `_factor_impl`,
    `_solve_impl`, `_iq_matvec_impl`, `_iq_rmatvec_impl`.

    `ad_counts` counts the family-AD passes: graphs captured, captures
    that failed, passes replayed and passes run eagerly.
    """

    def __init__(self, nlp, node_of_var, probe_seed=7, x0=None):
        nlp.freeze()
        self.nlp = nlp
        self.device = dev = nlp.device
        # the family AD's graphs by key (`_eval_core`; None: eager), the
        # capture step (None: every pass eager) and the graphs' memory pool
        self._ad_graphs = {}
        cuda = torch.device(dev).type == "cuda"
        self._ad_capture = _ADGraph if cuda else None
        self._ad_pool = torch.cuda.graph_pool_handle() if cuda else None
        self.ad_counts = dict(ad_captures=0, ad_capture_failures=0,
                              ad_replays=0, ad_eager=0)

        # ---- structural sparsity of every family: |J| at two points near
        # the initial trajectory, OR-ed over apps.  Hessian sparsity is
        # inferred: H = sum_k lam_k grad^2 f_k couples (i, j) only if some
        # row touches both and one of the two Jacobian columns varies
        # between the probe points.  The numpy generator and its draw order
        # match the JAX package, so the masks are identical. ----
        rng = np.random.default_rng(probe_seed)
        if x0 is not None:
            x0 = np.asarray(x0, np.float64)

        def probe(f):
            valjac = _family_valjac(f.fun)
            consts = config.tensor(f.consts, dev)
            jac_nz = np.zeros((f.nout, f.nin), bool)
            jxs = []
            for k in range(2):
                if x0 is not None:
                    base = x0[f.Vidx]
                    scale = np.maximum(np.abs(base), 1e-3)
                    xg = base + rng.normal(size=base.shape) * scale \
                        * (0.01 + 0.1 * k)
                else:
                    xg = rng.normal(size=(f.napps, f.nin)) * 0.7 + 0.3
                _, jx = valjac(config.tensor(xg, dev), consts)
                jxa = jx.cpu().numpy()
                jxs.append(jxa)
                jac_nz |= np.nanmax(np.abs(jxa), axis=0) > 1e-250
                jac_nz |= ~np.isfinite(jxa).all(axis=0)
            with np.errstate(invalid="ignore"):
                nonconst = (np.nanmax(np.abs(jxs[0] - jxs[1]), axis=0)
                            > 1e-250).any(axis=0)
            nonconst |= ~np.isfinite(jxs[0]).all(axis=(0, 1))
            nonconst |= ~np.isfinite(jxs[1]).all(axis=(0, 1))
            shared_row = np.zeros((f.nin, f.nin), bool)
            for k in range(f.nout):
                cols = jac_nz[k]
                shared_row |= cols[:, None] & cols[None, :]
            hess_nz = shared_row & (nonconst[:, None] | nonconst[None, :])
            hess_nz |= hess_nz.T
            return jac_nz, hess_nz

        eq_nz = [probe(f) for f in nlp.eqcons]
        iq_nz = [probe(f) for f in nlp.iqcons]
        obj_nz = [probe(f) for f in nlp.objectives]

        eq_fams = [(f.Vidx, rows, jnz.any(axis=0), hnz.any(axis=0))
                   for f, rows, (jnz, hnz) in zip(nlp.eqcons, nlp._eq_rows,
                                                  eq_nz)]
        # iq Hessian coupling includes the slack condensation J^T Sigma~ J:
        # all Jacobian-column pairs of an application couple
        iq_fams = [(f.Vidx, rows, jnz.any(axis=0),
                    jnz.any(axis=0) | hnz.any(axis=0))
                   for f, rows, (jnz, hnz) in zip(nlp.iqcons, nlp._iq_rows,
                                                  iq_nz)]
        obj_fams = [(f.Vidx, jnz.any(axis=0), hnz.any(axis=0))
                    for f, (jnz, hnz) in zip(nlp.objectives, obj_nz)]
        self.bs = BlockStructure(nlp.numPrimal, nlp.numEq, nlp.numIq,
                                 node_of_var, eq_fams, iq_fams, obj_fams)
        bs = self.bs
        self._perm = config.index(bs.rhs_perm(), dev)

        def fam_entry(f, rows, jnz, hnz):
            need_hess = bool(hnz.any())
            return dict(vj=_family_valjac(f.fun),
                        hess=_family_hess(f.fun) if need_hess else None,
                        Vidx=f.Vidx, Vidx_t=config.index(f.Vidx, dev),
                        rows=rows,
                        rows_t=None if rows is None
                        else config.index(rows, dev),
                        need_hess=need_hess, jnz=jnz, hnz=hnz,
                        nout=f.nout, nin=f.nin, napps=f.napps)

        self._eq = [fam_entry(f, rows, jnz, hnz)
                    for f, rows, (jnz, hnz) in zip(nlp.eqcons, nlp._eq_rows,
                                                   eq_nz)]
        self._iq = []
        for f, rows, (jnz, hnz) in zip(nlp.iqcons, nlp._iq_rows, iq_nz):
            fam = fam_entry(f, rows, jnz, hnz)
            # the condensation J^T Sig~ J fills the union of Jacobian-column
            # outer products: include it in the Hessian mask
            hfull = hnz.copy()
            for r in range(f.nout):
                hfull |= np.outer(jnz[r], jnz[r])
            fam["hfull"] = hfull
            self._iq.append(fam)
        self._obj = [fam_entry(f, None, jnz, hnz)
                     for f, (jnz, hnz) in zip(nlp.objectives, obj_nz)]
        # the family AD's profiler ranges: asset.ad.<eq|iq|obj><i>.<stage>
        for kind, fams in (("eq", self._eq), ("iq", self._iq),
                           ("obj", self._obj)):
            for i, fam in enumerate(fams):
                fam["spans"] = {t: f"asset.ad.{kind}{i}.{t}"
                                for t in ("gather", "vj", "hess")}
        self._build_plan()

        # regularization diagonal: +delta on primal slots, -gammaE on
        # equality-multiplier slots, 1 on the unused padded slots
        K, W, b = bs.K, bs.W, bs.b
        ar = np.arange(W)
        unused = ar[None, :] >= bs.counts[:, None]                 # (K, W)
        sign = np.zeros((K, W, W))
        fix = np.zeros((K, W, W))
        sign[:, ar, ar] = np.where(unused, 0.0, 1.0)
        fix[:, ar, ar] = unused.astype(np.float64)
        rmask = bs._urow_macro >= 0
        rm, rs = bs._urow_macro[rmask], bs._urow_slot[rmask]
        sign[rm, rs, rs] = -1.0
        csign = np.eye(b)
        for sl in bs.border_row_slot.values():
            csign[sl, sl] = -1.0
        self._d_pos = config.tensor(sign > 0, dev)
        self._d_neg = config.tensor(sign < 0, dev)
        self._d_fix = config.tensor(fix, dev)
        self._c_pos = config.tensor(csign > 0, dev)
        self._c_neg = config.tensor(csign < 0, dev)

    # ------------------------------------------------------------ build plan
    def _build_plan(self):
        """Gather-table assembly plan.

        Every family's J/H/condensation values are concatenated into one
        value buffer per evaluation (layout: eq jac, [eq hess], iq
        hess(+condensation), [obj hess]), and each KKT array is a static
        gather table + sum over its contributors: deterministic, no
        atomics."""
        bs = self.bs
        dev = self.device
        K, W, b, n = bs.K, bs.W, bs.b, bs.n
        off = 0
        pairs = dict(diag=[], lower=[], B=[], C=[])

        def add_targets(t, off):
            for name, lst in pairs.items():
                if name in t and len(t[name][0]):
                    s, tg = t[name]
                    lst.append((np.asarray(s, np.int64) + off, tg))

        for fam in self._eq:
            add_targets(bs.jac_targets(fam["Vidx"], fam["rows"], fam["jnz"]),
                        off)
            off += fam["napps"] * fam["nout"] * fam["nin"]
            if fam["need_hess"]:
                add_targets(bs.hess_targets(fam["Vidx"], fam["hnz"]), off)
                off += fam["napps"] * fam["nin"] * fam["nin"]
        for fam in self._iq:
            add_targets(bs.hess_targets(fam["Vidx"], fam["hfull"]), off)
            off += fam["napps"] * fam["nin"] * fam["nin"]
        for fam in self._obj:
            if fam["need_hess"]:
                add_targets(bs.hess_targets(fam["Vidx"], fam["hnz"]), off)
                off += fam["napps"] * fam["nin"] * fam["nin"]
        self._vbuf_len = off

        # diag / lower: compact tables over the occupied slots only
        self._tD = tuple(config.index(a, dev)
                         for a in _gather_rows(pairs["diag"], off))
        self._tL = tuple(config.index(a, dev)
                         for a in _gather_rows(pairs["lower"], off))
        self._tB = config.index(_build_table(pairs["B"], K * W * b, off),
                                dev)
        self._tC = config.index(_build_table(pairs["C"], b * b, off), dev)

        # adjoint-gradient plans: rd over every family, J_I^T v over the
        # inequality families
        fams = self._eq + self._iq + self._obj
        trd, brd = _grad_plan(fams, n, bs._uvar_macro)
        self._trd = config.index(trd, dev)
        self._rd_border = [(i, config.index(c, dev), config.index(ids, dev))
                           for i, c, ids in brd]
        tiq, biq = _grad_plan(self._iq, n, bs._uvar_macro)
        self._tiq = config.index(tiq, dev)
        self._iq_border = [(i, config.index(c, dev), config.index(ids, dev))
                           for i, c, ids in biq]

    # --------------------------------------------------- family evaluation
    def _eval_core(self, x, lamE, lamI, sigma, consts, want_hess):
        """`_eval_eager`'s (obj, cE, cI, rd, famvals), replayed from a CUDA
        graph captured at the first pass of each key (x's shape and
        device, `want_hess`, `sigma`, the consts' shapes); eager on the
        CPU and for a key whose capture failed."""
        graph = None
        if self._ad_capture is not None:
            key = (x.device, tuple(x.shape), want_hess, float(sigma),
                   tuple(tuple(c.shape) for group in consts for c in group))
            if key not in self._ad_graphs:
                try:
                    self._ad_graphs[key] = self._ad_capture(
                        self, x, lamE, lamI, sigma, consts, want_hess)
                    self.ad_counts["ad_captures"] += 1
                except RuntimeError:
                    # a host read or copy inside a family cannot be
                    # captured
                    self._ad_graphs[key] = None
                    self.ad_counts["ad_capture_failures"] += 1
            graph = self._ad_graphs[key]
        if graph is None:
            self.ad_counts["ad_eager"] += 1
            return self._eval_eager(x, lamE, lamI, sigma, consts, want_hess)
        self.ad_counts["ad_replays"] += 1
        return graph(x, lamE, lamI, consts)

    def _eval_eager(self, x, lamE, lamI, sigma, consts, want_hess):
        """One vmapped pass over every family: values + Jacobians (+
        adjoint Hessians when `want_hess` is True; structural zeros when it
        is "zeros", the first-order passes), assembled into obj/cE/cI/rd by
        concatenation and gather tables.

        x (B, n), lamE (B, mE), lamI (B, mI): B lanes of one structure.
        Each family runs once over the (B*napps) rows of every lane's
        applications; the consts are shared by every lane."""
        ocon, econ, icon = consts
        Bn = x.shape[0]
        dev = self.device
        famvals = dict(jx_eq=[], hx_eq=[], jx_iq=[], hx_iq=[], hx_obj=[])
        g2d = []
        ce, ci = [], []
        obj = torch.zeros((Bn,), dtype=config.DTYPE, device=dev)

        def one(fam, cc, lam):
            """One family over every lane; lam: the multipliers of every
            row (B, m), or None for an objective (unit weights)."""
            napps, nin = fam["napps"], fam["nin"]
            names = fam["spans"]
            with span(names["gather"]):
                xg = _lanes(x[:, fam["Vidx_t"]])
                cb = cc.repeat(Bn, 1)
                lb = torch.ones((Bn * napps, 1), dtype=config.DTYPE,
                                device=dev) if lam is None \
                    else _lanes(lam[:, fam["rows_t"]])
            with span(names["vj"]):
                fx, jx = fam["vj"](xg, cb)
                g = (jx * lb[:, :, None]).sum(1)
            hx = None
            if fam["need_hess"] and want_hess is True:
                with span(names["hess"]):
                    hx = fam["hess"](xg, cb, lb).reshape(Bn, napps, nin,
                                                         nin)
            elif fam["need_hess"] and want_hess == "zeros":
                hx = torch.zeros((Bn, napps, nin, nin), dtype=config.DTYPE,
                                 device=dev)
            return (fx.reshape(Bn, -1), g.reshape(Bn, napps, nin),
                    jx.reshape(Bn, napps, fam["nout"], nin), hx)

        for fam, cc in zip(self._eq, econ):
            fx, g, jx, hx = one(fam, cc, lamE)
            famvals["jx_eq"].append(jx)
            famvals["hx_eq"].append(hx)
            ce.append(fx)
            g2d.append(g)
        for fam, cc in zip(self._iq, icon):
            fx, g, jx, hx = one(fam, cc, lamI)
            famvals["jx_iq"].append(jx)
            famvals["hx_iq"].append(hx)
            ci.append(fx)
            g2d.append(g)
        for fam, cc in zip(self._obj, ocon):
            fx, g, jx, hx = one(fam, cc, None)
            obj = obj + fx.sum(-1)
            famvals["hx_obj"].append(sigma * hx if want_hess is True
                                     and hx is not None else hx)
            g2d.append(sigma * g)
        empty = torch.zeros((Bn, 0), dtype=config.DTYPE, device=dev)
        cE = torch.cat(ce, 1) if ce else empty
        cI = torch.cat(ci, 1) if ci else empty
        rd = _apply_grad_plan(self._trd, self._rd_border, g2d, Bn)
        return obj, cE, cI, rd, famvals

    def _resid_impl(self, x, lamE, lamI, sigma, consts):
        obj, cE, cI, rd, _ = self._eval_core(x, lamE, lamI, sigma, consts,
                                             want_hess=False)
        return obj, rd, cE, cI, rd   # 2nd slot (gradf) kept for API shape

    def eval_resid(self, x, lamE, lamI, sigma):
        """One problem's (obj, rd, cE, cI, rd) (no lane axis)."""
        out = self._resid_impl(x[None], lamE[None], lamI[None], sigma,
                               self.nlp.consts_dev())
        return tuple(o[0] for o in out)

    # ------------------------------------------------------ block assembly
    def _blocks_impl(self, famvals, sig_tilde):
        """Gather-table assembly of (diag, lower, B, C) from the family
        value buffer, for every lane (sig_tilde (B, mI)); the iq
        condensation J^T Sigma~ J is folded in here so the perturbation
        ladder refactors without re-running AD."""
        bs = self.bs
        K, W, b = bs.K, bs.W, bs.b
        Bn = sig_tilde.shape[0]
        dev = self.device
        vparts = []
        for i, fam in enumerate(self._eq):
            vparts.append(famvals["jx_eq"][i].reshape(Bn, -1))
            if fam["need_hess"]:
                vparts.append(famvals["hx_eq"][i].reshape(Bn, -1))
        for i, fam in enumerate(self._iq):
            jx = famvals["jx_iq"][i]
            jst = jx * sig_tilde[:, fam["rows_t"]][..., None]
            h = jst.transpose(-1, -2) @ jx
            if fam["need_hess"]:
                h = h + famvals["hx_iq"][i]
            vparts.append(h.reshape(Bn, -1))
        for i, fam in enumerate(self._obj):
            if fam["need_hess"]:
                vparts.append(famvals["hx_obj"][i].reshape(Bn, -1))
        vbuf = torch.cat(vparts + [torch.zeros((Bn, 1), dtype=config.DTYPE,
                                               device=dev)], 1)

        def compact(tab, size):
            rows, table = tab
            out = torch.zeros((Bn, size), dtype=config.DTYPE, device=dev)
            out[:, rows] = vbuf[:, table].sum(-1)
            return out

        diag = compact(self._tD, K * W * W).reshape(Bn, K, W, W)
        lower = compact(self._tL, K * W * W).reshape(Bn, K, W, W)
        B = vbuf[:, self._tB].sum(-1).reshape(Bn, K, W, b)
        C = vbuf[:, self._tC].sum(-1).reshape(Bn, b, b)
        return diag, lower, B, C

    # -------------------------------------------------------------- factor
    def _regularize(self, blocks, delta, gammaE):
        """Pre-assembled blocks (B, ...) with +delta on the primal slots,
        -gammaE on the equality-multiplier slots and 1 on the unused
        padded slots.  delta: a number, or one per lane (B,)."""
        diag, lower, B, C = blocks
        if torch.is_tensor(delta) and delta.dim() == 1:
            dd, dc = delta[:, None, None, None], delta[:, None, None]
        else:
            dd = dc = delta
        diag = diag + (self._d_pos * dd - self._d_neg * gammaE) \
            + self._d_fix
        C = C + (self._c_pos * dc - self._c_neg * gammaE)
        return diag, lower, B, C

    def _factor_blocks_impl(self, blocks, delta, gammaE):
        """Regularize + factor pre-assembled blocks (B, ...).  Returns the
        factor and the negative-eigenvalue count of each lane (B,)."""
        return bcr_factor(*self._regularize(blocks, delta, gammaE))

    def _factor_impl(self, x, lamE, lamI, sigma, sig_tilde, delta, gammaE,
                     consts):
        """AD + assembly + factor of every lane (x (B, n)); the factor
        keeps the inequality Jacobians for the matvecs."""
        _, _, _, _, famvals = self._eval_core(x, lamE, lamI, sigma, consts,
                                              want_hess=True)
        blocks = self._blocks_impl(famvals, sig_tilde)
        fac, neigs = self._factor_blocks_impl(blocks, delta, gammaE)
        fac["iq_jx"] = famvals["jx_iq"]
        return fac, neigs

    def factor(self, x, lamE, lamI, sigma, sig_tilde, delta, gammaE):
        """One problem: AD + assembly + factor; returns (fac, int neigs)."""
        fac, neigs = self._factor_impl(
            x[None], lamE[None], lamI[None], sigma, sig_tilde[None],
            float(delta), float(gammaE), self.nlp.consts_dev())
        return fac, int(neigs[0])

    # --------------------------------------------------------------- solve
    def _solve_impl(self, fac, rhs_x, rhs_E):
        """Solve every lane: rhs_x (B, n), rhs_E (B, mE) -> (dx, dlamE)."""
        bs = self.bs
        K, W, b = bs.K, bs.W, bs.b
        Bn = rhs_x.shape[0]
        full = torch.zeros((Bn, K * W + b), dtype=config.DTYPE,
                           device=self.device)
        full[:, self._perm] = torch.cat([rhs_x, rhs_E], 1)
        y, z = self._block_solve(fac, full[:, :K * W].reshape(Bn, K, W),
                                 full[:, K * W:])
        sol = torch.cat([y.reshape(Bn, -1), z], 1)[:, self._perm]
        return sol[:, :bs.n], sol[:, bs.n:]

    def _block_solve(self, fac, rhs_blocks, rhs_border):
        """(y (B,K,W), z (B,b)) of the factored block system."""
        return bcr_solve(fac, rhs_blocks, rhs_border)

    def solve(self, fac, rhs_x, rhs_E):
        """One problem's solve (rhs without the lane axis)."""
        dx, dlamE = self._solve_impl(fac, rhs_x[None], rhs_E[None])
        return dx[0], dlamE[0]

    # -------------------------------------------------------------- matvec
    def _iq_matvec_impl(self, fac, dx):
        """J_I dx for every lane (dx (B, n)).  Inequality rows are
        contiguous per family, so the per-family products concatenate."""
        Bn = dx.shape[0]
        parts = [_mv(jx, dx[:, fam["Vidx_t"]]).reshape(Bn, -1)
                 for fam, jx in zip(self._iq, fac["iq_jx"])]
        if not parts:
            return torch.zeros((Bn, 0), dtype=config.DTYPE,
                               device=self.device)
        return torch.cat(parts, 1)

    def _iq_rmatvec_impl(self, fac, v):
        """J_I^T v for every lane (v (B, mI)) through the inequality
        gather plan."""
        Bn = v.shape[0]
        if not self._iq:
            return torch.zeros((Bn, self.nlp.numPrimal), dtype=config.DTYPE,
                               device=self.device)
        parts = [(jx * v[:, fam["rows_t"]][..., None]).sum(2)
                 for fam, jx in zip(self._iq, fac["iq_jx"])]
        return _apply_grad_plan(self._tiq, self._iq_border, parts, Bn)

    def iq_matvec(self, fac, dx):
        return self._iq_matvec_impl(fac, dx[None])[0]

    def iq_rmatvec(self, fac, v):
        return self._iq_rmatvec_impl(fac, v[None])[0]
