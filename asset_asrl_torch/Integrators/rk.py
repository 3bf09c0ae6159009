"""Adaptive Runge-Kutta integrators (RK4 / DOPRI54 / DOPRI87).

Port of `asset_asrl_tpu/Integrators/rk.py`.  The integrator maps a full ODE
input row [x, t0, u, p] to the row at tf; with no control law, u is held
constant; a control law (a VectorFunction of [x, t] or of [t], or an
LGLInterpTable) closes the loop u = k(x, t).

* One step of one row (`body`) is a pure tensor function: the stage loop,
  the error norm, the step-size controller and the accept test hold no
  Python branch on a tensor value.  A row that has reached tf (or the step
  cap, or a non-finite state) keeps its carry through `torch.where`.
* Batch propagation is `torch.func.vmap` of that step over a (B, n) state
  with each row's own t, h, step count and ok flag; the Python loop ends
  when no row is active, which is checked on the host every `CheckEvery`
  steps (a few extra masked steps change nothing).  A row's step sequence,
  and so its result, does not depend on its batch mates.  `integrate` is
  the batch of one.
* The state-transition matrix is forward-mode AD (`torch.func.jacfwd`)
  through the whole adaptive loop, replayed at the step count the primal
  run took: the tangents of t and h flow with those of x (the next step
  size depends on x through the error norm), and every decision (accept,
  the clips) is taken from the primal values.  `integrate_stm2` nests it.
* Events are located by bisection on sign changes inside the batched loop,
  a fixed number of bisections under a mask.

Methods return numpy arrays and lists of rows; tensors are built on
`config.DEVICE` when a method is called.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .. import config
from ..VectorFunctions.function import VectorFunction

__all__ = ["Integrator", "RKCoeffs"]


class RKCoeffs:
    """Butcher tableaus (standard published coefficients)."""

    RK4 = dict(
        a=[[], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
        b=[1 / 6, 1 / 3, 1 / 3, 1 / 6],
        c=[0.0, 0.5, 0.5, 1.0],
        bhat=None, order=4)

    # Dormand-Prince 5(4)
    DOPRI54 = dict(
        a=[[],
           [1 / 5],
           [3 / 40, 9 / 40],
           [44 / 45, -56 / 15, 32 / 9],
           [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
           [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
           [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]],
        b=[35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0],
        bhat=[5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
              187 / 2100, 1 / 40],
        c=[0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0],
        order=5)

    # Prince-Dormand 8(7) (RK8(7)13M)
    DOPRI87 = dict(
        a=[[],
           [1 / 18],
           [1 / 48, 1 / 16],
           [1 / 32, 0, 3 / 32],
           [5 / 16, 0, -75 / 64, 75 / 64],
           [3 / 80, 0, 0, 3 / 16, 3 / 20],
           [29443841 / 614563906, 0, 0, 77736538 / 692538347,
            -28693883 / 1125000000, 23124283 / 1800000000],
           [16016141 / 946692911, 0, 0, 61564180 / 158732637,
            22789713 / 633445777, 545815736 / 2771057229,
            -180193667 / 1043307555],
           [39632708 / 573591083, 0, 0, -433636366 / 683701615,
            -421739975 / 2616292301, 100302831 / 723423059,
            790204164 / 839813087, 800635310 / 3783071287],
           [246121993 / 1340847787, 0, 0, -37695042795 / 15268766246,
            -309121744 / 1061227803, -12992083 / 490766935,
            6005943493 / 2108947869, 393006217 / 1396673457,
            123872331 / 1001029789],
           [-1028468189 / 846180014, 0, 0, 8478235783 / 508512852,
            1311729495 / 1432422823, -10304129995 / 1701304382,
            -48777925059 / 3047939560, 15336726248 / 1032824649,
            -45442868181 / 3398467696, 3065993473 / 597172653],
           [185892177 / 718116043, 0, 0, -3185094517 / 667107341,
            -477755414 / 1098053517, -703635378 / 230739211,
            5731566787 / 1027545527, 5232866602 / 850066563,
            -4093664535 / 808688257, 3962137247 / 1805957418,
            65686358 / 487910083],
           [403863854 / 491063109, 0, 0, -5068492393 / 434740067,
            -411421997 / 543043805, 652783627 / 914296604,
            11173962825 / 925320556, -13158990841 / 6184727034,
            3936647629 / 1978049680, -160528059 / 685178525,
            248638103 / 1413531060, 0]],
        b=[14005451 / 335480064, 0, 0, 0, 0, -59238493 / 1068277825,
           181606767 / 758867731, 561292985 / 797845732,
           -1041891430 / 1371343529, 760417239 / 1151165299,
           118820643 / 751138087, -528747749 / 2220607170, 1 / 4],
        bhat=[13451932 / 455176623, 0, 0, 0, 0, -808719846 / 976000145,
              1757004468 / 5645159321, 656045339 / 265891186,
              -3867574721 / 1518517206, 465885868 / 322736535,
              53011238 / 667516719, 2 / 45, 0],
        c=[0, 1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
           5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798, 1, 1],
        order=8)

    @classmethod
    def get(cls, name):
        return {"RK4": cls.RK4, "RK4Classic": cls.RK4,
                "DOPRI54": cls.DOPRI54, "DOPRI87": cls.DOPRI87}[name]


def _wsum(ws, ks):
    """sum_j ws[j] * ks[j] over the non-zero weights, accumulated
    elementwise in stage order."""
    acc = None
    for w, k in zip(ws, ks):
        if w != 0.0:
            acc = w * k if acc is None else acc + w * k
    return acc


class _Core:
    """The closures of one integrator configuration, all for one row:
    init(row, tf) -> (carry, consts); active(carry, consts) -> bool;
    body(carry, consts) -> carry; finish(carry, consts) -> row.
    carry = (x, t, h, nst, ok), consts = (tf, sgn, u0, p)."""

    def __init__(self, init, active, body, finish):
        self.init, self.active, self.body, self.finish = \
            init, active, body, finish

    def run_fixed(self, row, tf, nsteps):
        """The adaptive loop replayed for `nsteps` masked steps: a pure
        function of (row, tf), for forward-mode AD."""
        carry, consts = self.init(row, tf)
        for _ in range(nsteps):
            carry = self.body(carry, consts)
        return self.finish(carry, consts)


class Integrator:
    """Adaptive/fixed-step integrator over a full ODE input row."""

    # steps between two host checks of "is any row still active"
    CheckEvery = 8

    def __init__(self, ode, defstep=0.01, controller=None, uvars=None,
                 method="DOPRI54"):
        # overload: Integrator(ode, "DOPRI87", dt[, law, uvars])
        if isinstance(defstep, str):
            if isinstance(controller, (int, float)):
                defstep, controller, uvars, method = (
                    float(controller), uvars,
                    method if not isinstance(method, str) else None,
                    defstep)
            else:
                defstep, method = 0.01, defstep
        self.ode = ode
        self.DefStepSize = float(defstep)
        self.MinStepSize = self.DefStepSize * 1e-6
        self.MaxStepSize = self.DefStepSize * 1e6
        self.Adaptive = True
        self.AbsTols = np.full(ode.XVars(), 1.0e-12)
        self.RelTols = np.full(ode.XVars(), 0.0)
        self.EventTol = 1.0e-10
        self.MaxEventIters = 60
        self.MaxStepsPerCall = 100000
        self.FastAdaptiveSTM = True
        self.VectorizeBatchCalls = True
        self.method = method
        self._controller = controller
        if uvars is not None:
            # Vgroup names resolve through the ODE
            # (integ = ode.integrator(dt, law, "m"))
            groups = getattr(ode, "Vgroups", {}) or {}
            if isinstance(uvars, str):
                uvars = list(groups[uvars])
            else:
                out = []
                for v in uvars:
                    if isinstance(v, str):
                        out.extend(groups[v])
                    else:
                        out.append(int(v))
                uvars = out
        self._uvars = None if uvars is None else [int(v) for v in uvars]
        # steps of the longest row in the last call (accepted + rejected)
        self.LastStepCount = 0

    # ------------------------------------------------------------ properties
    def setAbsTol(self, tol):
        self.AbsTols = np.full(self.ode.XVars(), float(tol))

    def setRelTol(self, tol):
        self.RelTols = np.full(self.ode.XVars(), float(tol))

    def setAbsTols(self, tols):
        self.AbsTols = np.asarray(tols, dtype=np.float64)

    def setStepSizes(self, defstep, minstep, maxstep):
        self.DefStepSize = float(defstep)
        self.MinStepSize = float(minstep)
        self.MaxStepSize = float(maxstep)

    # --------------------------------------------------------------- closure
    def _u_of(self, x, t, u0):
        """Control at (x, t): constant u0, a control-law VectorFunction, or
        an LGLInterpTable."""
        ctrl = self._controller
        UV = self.ode.UVars()
        if ctrl is None or UV == 0:
            return u0
        from ..OptimalControl.interp_table import LGLInterpTable
        if isinstance(ctrl, LGLInterpTable):
            row = ctrl.interp_traced(t)
            if self._uvars is not None:
                # uvars index the table's stored row (time removed)
                return torch.stack([row[i if i < ctrl.tcol else i - 1]
                                    for i in self._uvars])
            # default: trailing UV columns of the table
            return row[-UV:]
        if isinstance(ctrl, VectorFunction):
            xt = torch.cat([x, torch.atleast_1d(t)])
            if self._uvars is not None:
                # uvars select the law's inputs from [x, t]
                return ctrl.trace(torch.stack([xt[i] for i in self._uvars]))
            if ctrl.IRows() == self.ode.XVars() + 1:
                return ctrl.trace(xt)
            if ctrl.IRows() == 1:
                return ctrl.trace(torch.atleast_1d(t))
            raise ValueError("control law must take [x,t] or [t]")
        raise TypeError("unsupported controller")

    def _rhs(self, x, t, u0, p):
        u = self._u_of(x, t, u0)
        return self.ode.vf().trace(torch.cat([x, torch.atleast_1d(t), u, p]))

    def _full_row(self, x, t, u0, p):
        return torch.cat([x, torch.atleast_1d(t), self._u_of(x, t, u0), p])

    def _split(self, row):
        XV, UV = self.ode.XVars(), self.ode.UVars()
        return (row[..., :XV], row[..., XV], row[..., XV + 1:XV + 1 + UV],
                row[..., XV + 1 + UV:])

    # ------------------------------------------------------------- core step
    def _make_step(self):
        """step(x, t, h, u0, p) -> (x after one RK step of size h, the
        embedded error estimate), for one row."""
        tab = RKCoeffs.get(self.method)
        A = [[float(a) for a in r] for r in tab["a"]]
        b = [float(v) for v in tab["b"]]
        db = None if tab["bhat"] is None else \
            [float(v) - float(w) for v, w in zip(tab["b"], tab["bhat"])]
        c = [float(v) for v in tab["c"]]
        rhs = self._rhs

        def step(x, t, h, u0, p):
            ks = []
            for i in range(len(b)):
                acc = _wsum(A[i], ks) if i > 0 else None
                xi = x if acc is None else x + h * acc
                ks.append(rhs(xi, t + c[i] * h, u0, p))
            xn = x + h * _wsum(b, ks)
            err = torch.zeros_like(x) if db is None else h * _wsum(db, ks)
            return xn, err
        return step

    def _controller_consts(self):
        tab = RKCoeffs.get(self.method)
        return dict(order=tab["order"],
                    abst=config.tensor(self.AbsTols),
                    relt=config.tensor(self.RelTols),
                    hmin=self.MinStepSize, hmax=self.MaxStepSize,
                    adaptive=self.Adaptive and tab["bhat"] is not None)

    @staticmethod
    def _propose(cc, xn, err, hstep):
        """The error norm's verdict on one step: (next step size, accept)."""
        tol = cc["abst"] + torch.abs(xn) * cc["relt"]
        enorm = torch.sqrt(torch.mean((err / tol) ** 2, dim=-1))
        enorm = torch.clamp(enorm, min=1e-16)
        fac = torch.clamp(0.9 * enorm ** (-1.0 / cc["order"]), 0.2, 5.0)
        hnew = torch.clamp(torch.abs(hstep) * fac, cc["hmin"], cc["hmax"])
        accept = (enorm <= 1.0) | (torch.abs(hstep) <= cc["hmin"] * 1.01)
        return hnew, accept

    @staticmethod
    def _unfinished(t, tf):
        return torch.abs(tf - t) > 1e-14 * torch.clamp(torch.abs(tf),
                                                       min=1.0)

    def _make_core(self):
        step = self._make_step()
        cc = self._controller_consts()
        max_steps = self.MaxStepsPerCall
        defstep = self.DefStepSize

        def init(row, tf):
            x0, t0, u0, p = self._split(row)
            sgn = torch.sign(tf - t0)
            sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
            carry = (x0, t0, torch.full_like(t0, defstep),
                     torch.zeros_like(t0, dtype=torch.int64),
                     torch.ones_like(t0, dtype=torch.bool))
            return carry, (tf, sgn, u0, p)

        def active(carry, consts):
            x, t, h, nst, ok = carry
            return self._unfinished(t, consts[0]) & (nst < max_steps) & ok

        def body(carry, consts):
            x, t, h, nst, ok = carry
            tf, sgn, u0, p = consts
            act = active(carry, consts)
            hstep = sgn * torch.minimum(h, torch.abs(tf - t))
            xn, err = step(x, t, hstep, u0, p)
            if cc["adaptive"]:
                hnew, accept = self._propose(cc, xn, err, hstep)
                x2 = torch.where(accept, xn, x)
                t2 = torch.where(accept, t + hstep, t)
            else:
                x2, t2, hnew = xn, t + hstep, h
            ok2 = torch.isfinite(torch.sum(x2))
            return (torch.where(act, x2, x), torch.where(act, t2, t),
                    torch.where(act, hnew, h), nst + act,
                    torch.where(act, ok2, ok))

        def finish(carry, consts):
            x, t = carry[0], carry[1]
            _, _, u0, p = consts
            return self._full_row(x, t, u0, p)

        return _Core(init, active, body, finish)

    def _advance(self, rows, tfs):
        """Integrate every row of `rows` (B, rowlen) to its `tfs` (B,):
        (final rows (B, rowlen), masked steps run, the core)."""
        core = self._make_core()
        carry, consts = vmap(core.init)(rows, tfs)
        vbody, vactive = vmap(core.body), vmap(core.active)
        n = 0
        while True:
            if n % self.CheckEvery == 0 \
                    and not bool(vactive(carry, consts).any()):
                break
            carry = vbody(carry, consts)
            n += 1
        self.LastStepCount = int(carry[3].max())
        return vmap(core.finish)(carry, consts), n, core

    # ------------------------------------------------------------ public API
    def _row(self, x0):
        row = np.asarray(x0, dtype=np.float64).ravel()
        need = self.ode.XtUPVars()
        if row.size == need:
            return row
        if row.size < need:
            row = np.concatenate([row, np.zeros(need - row.size)])
        return row[:need]

    def _rows(self, x0s, tfs):
        rows = config.tensor(np.stack([self._row(r) for r in x0s]))
        tfs = config.tensor(np.asarray(tfs, dtype=np.float64).reshape(-1))
        return rows, tfs

    def integrate(self, x0, tf):
        rows, tfs = self._rows([x0], [float(tf)])
        return self._advance(rows, tfs)[0][0].cpu().numpy()

    def integrate_parallel(self, x0s, tfs):
        out = self._advance(*self._rows(x0s, tfs))[0].cpu().numpy()
        return [r for r in out]

    def _stm(self, x0s, tfs, order):
        """Final rows and their derivatives up to `order` with respect to
        the initial rows: forward-mode AD through the adaptive loop,
        replayed for the step count of the primal run."""
        rows, tfs = self._rows(x0s, tfs)
        xf, n, core = self._advance(rows, tfs)
        outs = [xf]
        fn = core.run_fixed
        for _ in range(order):
            fn = jacfwd(fn)
            outs.append(vmap(lambda r, t, fn=fn: fn(r, t, n))(rows, tfs))
        return [o.cpu().numpy() for o in outs]

    def integrate_stm(self, x0, tf):
        xf, jac = self._stm([x0], [float(tf)], 1)
        return xf[0], jac[0]

    def integrate_stm2(self, x0, tf):
        """State-transition matrix and the second-order sensitivities
        d2 x(tf) / d x0^2, by forward-over-forward AD through the adaptive
        loop."""
        xf, jac, hess = self._stm([x0], [float(tf)], 2)
        return xf[0], jac[0], hess[0]

    def integrate_stm_parallel(self, x0s, tfs, ncores=None):
        xfs, jacs = self._stm(x0s, tfs, 1)
        return [(x, j) for x, j in zip(xfs, jacs)]

    # ---------------------------------------------------------------- events
    def _norm_events(self, events):
        """Normalize to [(func, direction, stop)] and classify: all
        VectorFunctions (the batched in-loop path) or not (host path)."""
        if callable(events) or isinstance(events, VectorFunction):
            events = [events]
        evs = []
        all_vf = True
        for ev in events:
            if isinstance(ev, (tuple, list)):
                f, direction, stop = (list(ev) + [0, 0])[:3]
            else:
                f, direction, stop = ev, 0, 1
            if not isinstance(f, VectorFunction):
                all_vf = False
            evs.append((f, int(direction), int(stop)))
        return evs, all_vf

    def _run_events(self, rows, tfs, evs, max_hits=4):
        """Event-locating integration of a batch: detection and bisection
        run inside the propagation loop.  Returns (final rows (B, rowlen),
        hits (B, nev, max_hits, rowlen), counts (B, nev)).  A row stops at
        the first crossing of any event with stop = 1."""
        dev = config.DEVICE
        XV = self.ode.XVars()
        B, rowlen = rows.shape
        nev = len(evs)
        evfuns = [f for f, _, _ in evs]
        dirs = config.index([d for _, d, _ in evs])
        stops = config.index([s for _, _, s in evs]) == 1
        cc = self._controller_consts()
        max_steps = self.MaxStepsPerCall
        nbisect = 40
        vstep = vmap(self._make_step())
        vfull = vmap(self._full_row)

        def ev_of(i):
            f = evfuns[i]
            return vmap(lambda x, t, u0, p: f.trace(
                self._full_row(x, t, u0, p)[:f.IRows()])[0])
        vevs = [ev_of(i) for i in range(nev)]

        def ev_vals(x, t, u0, p):
            return torch.stack([ve(x, t, u0, p) for ve in vevs], dim=1)

        def locate(xp, tp, tn, v0s, u0, p, crossed):
            """Bisect each crossed event on [tp, tn] from state xp: one RK
            step per trial midpoint and event."""
            ta = tp[:, None].expand(B, nev)
            tb = tn[:, None].expand(B, nev)
            for _ in range(nbisect):
                tm = 0.5 * (ta + tb)
                vm = torch.stack([
                    vevs[i](vstep(xp, tp, tm[:, i] - tp, u0, p)[0],
                            tm[:, i], u0, p) for i in range(nev)], dim=1)
                lo = v0s * vm <= 0              # crossing in [ta, tm]
                ta, tb = (torch.where(crossed & ~lo, tm, ta),
                          torch.where(crossed & lo, tm, tb))
            return tb

        x, t, u0, p = self._split(rows)
        tf = tfs
        sgn = torch.sign(tf - t)
        sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
        h = torch.full_like(t, self.DefStepSize)
        nst = torch.zeros(B, dtype=torch.int64, device=dev)
        ok = torch.ones(B, dtype=torch.bool, device=dev)
        stop = torch.zeros(B, dtype=torch.bool, device=dev)
        hits = torch.zeros((B, nev, max_hits, rowlen), dtype=config.DTYPE,
                           device=dev)
        counts = torch.zeros((B, nev), dtype=torch.int64, device=dev)
        slots = torch.arange(max_hits, device=dev)[None, :]
        vprev = ev_vals(x, t, u0, p)
        while True:
            act = self._unfinished(t, tf) & (nst < max_steps) & ok & ~stop
            if not bool(act.any()):
                break
            hstep = sgn * torch.minimum(h, torch.abs(tf - t))
            xn, err = vstep(x, t, hstep, u0, p)
            if cc["adaptive"]:
                hnew, accept = self._propose(cc, xn, err, hstep)
            else:
                hnew, accept = h, torch.ones_like(ok)
            tn = t + hstep
            vn = ev_vals(xn, tn, u0, p)
            rising = vn > vprev
            dirok = (dirs == 0) | ((dirs > 0) & rising) \
                | ((dirs < 0) & ~rising)
            upd = act & accept
            crossed = upd[:, None] & (vprev * vn < 0) & dirok \
                & (counts < max_hits)
            if bool(crossed.any()):
                tcs = locate(x, t, tn, vprev, u0, p, crossed)
                for i in range(nev):
                    xc, _ = vstep(x, t, tcs[:, i] - t, u0, p)
                    rowc = vfull(xc, tcs[:, i], u0, p)
                    slot = (slots == counts[:, i:i + 1]) \
                        & crossed[:, i:i + 1]
                    hits[:, i] = torch.where(slot[:, :, None],
                                             rowc[:, None, :], hits[:, i])
                counts = counts + crossed
            stop = stop | (crossed & stops).any(dim=1)
            x = torch.where(upd[:, None], xn, x)
            t = torch.where(upd, tn, t)
            vprev = torch.where(upd[:, None], vn, vprev)
            h = torch.where(act, hnew, h)
            nst = nst + act
            ok = torch.where(act, torch.isfinite(x.sum(dim=1)), ok)
        self.LastStepCount = int(nst.max())
        final = vfull(x, t, u0, p)
        # when a stop event fired, the terminal row is the earliest
        # stopping crossing (the integration stops at the event)
        last = torch.clamp(counts - 1, min=0)[:, :, None, None]
        last_rows = hits.gather(
            2, last.expand(B, nev, 1, rowlen)).squeeze(2)   # (B, nev, R)
        inf = torch.full_like(last_rows[:, :, XV], float("inf"))
        tcand = torch.where(stops & (counts > 0),
                            sgn[:, None] * last_rows[:, :, XV], inf)
        best = torch.argmin(tcand, dim=1)
        rng = torch.arange(B, device=dev)
        use = stop & torch.isfinite(tcand[rng, best])
        final = torch.where(use[:, None], last_rows[rng, best], final)
        return final, hits, counts

    def _dense_rows(self, x0s, tfs, nsteps):
        """Dense output of a batch: every row on its own grid of `nsteps`
        points (default: one per default step) from its t0 to its tf,
        point k of all rows in one batched call.  A row whose grid is
        spent waits at its tf.  Returns one list of rows per trajectory."""
        XV, UV = self.ode.XVars(), self.ode.UVars()
        rows = [self._row(r) for r in x0s]
        grids = []
        for row, tf in zip(rows, tfs):
            n = nsteps or max(
                int(abs(float(tf) - row[XV]) / self.DefStepSize) + 1, 2)
            grids.append(np.linspace(row[XV], float(tf), int(n)))
        cur = config.tensor(np.stack(rows))
        out = []
        for k in range(1, max(len(g) for g in grids)):
            cur = self._advance(cur, config.tensor(
                [g[min(k, len(g) - 1)] for g in grids]))[0]
            out.append(cur)
        first = np.stack(rows)
        if self._controller is not None and UV:
            # the control-law closure defines u everywhere, including t0
            x, t, u0, _ = self._split(config.tensor(first))
            first[:, XV + 1:XV + 1 + UV] = vmap(self._u_of)(
                x, t, u0).cpu().numpy()
        dense = torch.stack(out, dim=1).cpu().numpy() if out else None
        return [[first[b]] + [dense[b, k] for k in range(len(g) - 1)]
                for b, g in enumerate(grids)]

    def _dense_after_events(self, x0s, xfs, hits, counts, nsteps):
        """Per trajectory: the dense rows up to the event run's terminal
        row, and the located event rows as lists."""
        XV = self.ode.XVars()
        trajs = self._dense_rows(x0s, xfs[:, XV], nsteps)
        out = []
        for b, traj in enumerate(trajs):
            traj[-1] = xfs[b]
            out.append((traj, [[hits[b, i, k]
                                for k in range(int(counts[b, i]))]
                               for i in range(counts.shape[1])]))
        return out

    def integrate_dense(self, x0, tf, nsteps=None, events=None,
                        max_hits=4):
        """Dense-output integration (+ optional event detection).

        With VectorFunction events the trajectory is propagated twice (one
        event sweep + one dense-grid pass); with Python-callable events
        the bisection runs on the host per grid interval, a compatibility
        path that is far slower.  Prefer VectorFunction events, or
        `integrate_dense_parallel` for batches."""
        # overloads: integrate_dense(x0, tf, [events...]): a list/tuple of
        # events (or a bare callable) in the nsteps slot
        if events is None and nsteps is not None and not isinstance(
                nsteps, (int, np.integer)):
            events, nsteps = nsteps, None
        if not events:
            return self._dense_rows([x0], [tf], nsteps)[0]
        evs, all_vf = self._norm_events(events)
        tuple_form = isinstance(events, (list, tuple)) and any(
            isinstance(e, (list, tuple)) for e in events)
        if all_vf:
            traj, locs = self.integrate_dense_parallel(
                [x0], [tf], events, nsteps=nsteps, max_hits=max_hits)[0]
            return (traj, locs) if tuple_form else traj
        row = self._row(x0)
        traj = self._integrate_dense_events(row, row[self.ode.XVars()],
                                            float(tf), nsteps, events)
        return (traj, [traj[-1]]) if tuple_form else traj

    def integrate_dense_parallel(self, x0s, tfs, events=None, ncores=None,
                                 nsteps=None, max_hits=4):
        # integrate_dense_parallel(IGs, ts, events, nthreads): the batch
        # event sweep is one batched loop over all trajectories
        if events is not None and not isinstance(events, (list, tuple)):
            events = [events]
        if events is not None and len(events) and not any(
                isinstance(e, (tuple, list)) or
                isinstance(e, VectorFunction) or callable(e)
                for e in events):
            events = None
        if not events:
            return self._dense_rows(x0s, tfs, nsteps)
        evs, all_vf = self._norm_events(events)
        if all_vf:
            xfs, hits, counts = (a.cpu().numpy() for a in self._run_events(
                *self._rows(x0s, tfs), evs, max_hits))
            return self._dense_after_events(x0s, xfs, hits, counts, nsteps)
        return [self.integrate_dense(x, t, nsteps, events)
                for x, t in zip(x0s, tfs)]

    def _integrate_dense_events(self, row, t0, tf, nsteps, events):
        """Bisection event location on a dense grid, on the host, for
        events that are Python callables.  events: list of (func,
        direction, stop)."""
        evs, _ = self._norm_events(events)
        XV = self.ode.XVars()
        n = nsteps or max(int(abs(tf - t0) / self.DefStepSize) + 1, 2)
        traj = self.integrate_dense(row, tf, n)

        def evval(f, r):
            if isinstance(f, VectorFunction):
                return float(np.asarray(f.compute(r[:f.IRows()])).ravel()[0])
            out = f(np.asarray(r))
            if isinstance(out, (bool, np.bool_)):
                return 1.0 if out else -1.0
            return float(np.asarray(out).ravel()[0])

        out = [traj[0]]
        for i in range(1, len(traj)):
            r0, r1 = traj[i - 1], traj[i]
            for (f, direction, stop) in evs:
                v0, v1 = evval(f, r0), evval(f, r1)
                crossed = (v0 * v1 < 0) and (
                    direction == 0 or (direction > 0 and v1 > v0)
                    or (direction < 0 and v1 < v0))
                if crossed and stop:
                    ta, tb = r0[XV], r1[XV]
                    ra = r0
                    for _ in range(self.MaxEventIters):
                        tm = 0.5 * (ta + tb)
                        rm = self.integrate(ra, tm)
                        vm = evval(f, rm)
                        if v0 * vm <= 0:
                            tb = tm
                        else:
                            ta, ra, v0 = tm, rm, vm
                        if abs(tb - ta) < self.EventTol:
                            break
                    out.append(self.integrate(r0, tb))
                    return out
            out.append(r1)
        return out
