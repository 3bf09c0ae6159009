"""Entry "ensemble": a Monte-Carlo dispersion analysis, one
`parallel.solve_ensemble` call of `lanes` scenarios each unit, every lane
the complete fused solve from its own start."""

import numpy as np

from portbench.entries.common import make_phase

# the lanes of one call in a CPU test
TEST_LANES = 4


class Driver:
    unit_name = "portbench.ensemble"

    def __init__(self, ast, config, cfg, traffic):
        from asset_asrl_torch.parallel import solve_ensemble
        self.solve_ensemble = solve_ensemble
        self.phase, self.base = make_phase(ast, config, cfg)
        self.optimizer = self.phase.optimizer
        self.nlp = self.phase._nlp
        self.sigma = float(self.optimizer.ObjScale)

    def unit(self, starts):
        res = self.solve_ensemble(self.phase, x0s=starts)
        return dict(x=res["x"], lamE=res["lamE"], lamI=res["lamI"],
                    obj=res["objs"], flag=np.asarray(res["flags"]),
                    iters=np.asarray(res["iters"]),
                    stats=dict(self.phase.optimizer.LastFusedStats or {}))
