"""Entry "ocp_solve": one caller re-solving one multi-phase problem,
`OptimalControlProblem.solve_optimize()` (an SOE pass, then an OPT pass)
from a new start each unit.

The start becomes the problem's guess through `collectSolverOutput`, so
the window re-transcribes nothing (each solve refreshes the consts); the
answer is the problem's solver vector after the solve with the
optimizer's multipliers and objective, and the unit's stats are the
fused passes' counters summed (`PSIOPT.LastFusedStats`) with the
problem's host seconds around the optimizer (`LastSolveStats`).
"""

import numpy as np

# the lanes of one unit in a CPU test: the traffic's own (one)
TEST_LANES = None


class Driver:
    unit_name = "portbench.ocp_solve"

    def __init__(self, ast, config, cfg, traffic):
        if int(traffic["lanes"]) != 1:
            raise ValueError("the ocp_solve entry takes one lane")
        self.ocp = config.build(ast, cfg)
        self.optimizer = self.ocp.optimizer
        self.optimizer.set_PrintLevel(3)
        self.nlp = self.ocp._nlp
        self.base = self.ocp.makeSolverInput()
        self.sigma = float(self.optimizer.ObjScale)

    def unit(self, starts):
        """Solve from starts (1, n); returns the answers (1 lane) and the
        solve's counters."""
        self.ocp.collectSolverOutput(starts[0])
        flag = self.ocp.solve_optimize()
        opt = self.optimizer
        return dict(x=self.ocp.makeSolverInput()[None],
                    lamE=np.asarray(opt.LastEqLmults)[None],
                    lamI=np.asarray(opt.LastIqLmults)[None],
                    obj=np.array([opt.LastObjVal]),
                    flag=np.array([int(flag)]),
                    iters=np.array([opt.LastIterNum]),
                    stats=dict(opt.LastFusedStats or {},
                               **(self.ocp.LastSolveStats or {})))
