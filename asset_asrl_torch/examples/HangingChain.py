"""Hanging-chain catenary family via Jet ensemble (reference
`examples/HangingChain.py`): minimize potential energy of a chain of fixed
length L between two anchor heights, swept over L with Jet.map."""

import numpy as np
import asset_asrl_torch as ast

vf = ast.VectorFunctions
oc = ast.OptimalControl
Args = vf.Arguments
solvs = ast.Solvers


class Chain(oc.ODEBase):
    def __init__(self):
        args = oc.ODEArguments(1, 1)
        super().__init__(args[2], 1, 1)


def Energy():
    x, u = Args(2).tolist()
    return x * vf.sqrt(1 + u ** 2)


def Length():
    u, = Args(1).tolist()
    return vf.sqrt(1 + u ** 2)


def GetIG(a, b, ts):
    IG = []
    for t in ts:
        tm = .25 if b > a else .75
        x = 2 * abs(b - a) * t * (t - 2 * tm) + a
        u = 2 * abs(b - a) * (t * 2.0 - 2 * tm)
        IG.append([x, t, u])
    return IG


def Job(a, b, n, L):
    ts = np.linspace(0, 1, n)
    IG = GetIG(a, b, ts)
    phase = Chain().phase("LGL5", IG, n)
    phase.setStaticParams([L])
    phase.addBoundaryValue("Front", [0, 1], [a, 0])
    phase.addBoundaryValue("Back", [0, 1], [b, 1])
    phase.addBoundaryValue("StaticParams", [0], [L])
    phase.addUpperVarBound("Path", 0, max(a, b) + .001)
    phase.addIntegralObjective(Energy(), [0, 2])
    phase.addIntegralParamFunction(Length(), [2], 0)
    phase.optimizer.set_OptLSMode("L1")
    phase.optimizer.set_MaxLSIters(2)
    phase.optimizer.PrintLevel = 1
    phase.JetJobMode = "SolveOptimize"
    return phase


def run(a=1, b=3, n=100, Ls=None, nthreads=8):
    """Sweep chain length L with a Jet ensemble; returns the solved
    phases (reference `Jet.map`, `src/Solvers/Jet.h:92-151`)."""
    if Ls is None:
        Ls = np.linspace(2.25, 8, 8)
    JArgs = [(a, b, n, L) for L in Ls]
    return solvs.Jet.map(Job, JArgs, nthreads, True)


if __name__ == "__main__":
    Res = run()

    try:
        import matplotlib.pyplot as plt
        for res in Res:
            TT = np.array(res.returnTraj()).T
            plt.plot(TT[1], TT[0])
        plt.grid(True); plt.xlabel("x"); plt.ylabel("y")
        plt.show()
    except ImportError:
        pass
