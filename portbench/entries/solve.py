"""Entry "solve": one caller re-solving one problem, `Phase.optimize()`
from a new start each unit.

The start becomes the phase's guess through `collectSolverOutput`, so the
window re-transcribes nothing; the answer is the phase's solver vector
after the solve with the optimizer's multipliers and objective.
"""

import numpy as np

from portbench.entries.common import make_phase

# the lanes of one unit in a CPU test: the traffic's own (one)
TEST_LANES = None


class Driver:
    unit_name = "portbench.solve"

    def __init__(self, ast, config, cfg, traffic):
        if int(traffic["lanes"]) != 1:
            raise ValueError("the solve entry takes one lane")
        self.phase, self.base = make_phase(ast, config, cfg)
        self.optimizer = self.phase.optimizer
        self.nlp = self.phase._nlp
        self.sigma = float(self.optimizer.ObjScale)
        self.ast = ast

    def unit(self, starts):
        """Solve from starts (1, n); returns the answers (1 lane) and the
        fused loop's counters."""
        self.phase.collectSolverOutput(starts[0])
        flag = self.phase.optimize()
        opt = self.optimizer
        st = opt.LastFusedStats or {}
        return dict(x=self.phase.makeSolverInput()[None],
                    lamE=np.asarray(opt.LastEqLmults)[None],
                    lamI=np.asarray(opt.LastIqLmults)[None],
                    obj=np.array([opt.LastObjVal]),
                    flag=np.array([int(flag)]),
                    iters=np.array([opt.LastIterNum]),
                    stats=dict(st))

    def probe(self):
        """`PSIOPT.measure_stage_times` at the last solve's final iterate:
        seconds of family AD, assembly, factor, solve and the value pass
        (mean of 3 after a warm call, each ending in a synchronize)."""
        opt, cfg = self.optimizer, self.ast.config
        dev = self.nlp.device
        state = [cfg.tensor(a, dev) for a in (
            self.phase.makeSolverInput(), opt.LastSlacks, opt.LastEqLmults,
            opt.LastIqLmults)]
        return dict(opt.measure_stage_times(*state, opt.initMu,
                                            opt.ObjScale))
