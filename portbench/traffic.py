"""The one generator of every cell's inputs.

A workload file's "traffic" says how each unit of the window starts
from the base, the configuration's initial guess:

    perturb   "relative": base * (1 + scale N(0, 1)) on every variable;
              "additive": base + scale N(0, 1) on every variable
    scale     the size of the draw
    lanes     starts in one unit (1: a solve; more: an ensemble call)

`Starts(traffic, base, seed, stream)` draws the units one after another
from numpy's PCG64 seeded with (seed, stream): the same seed gives the
same starts in the same order.  Stream 0 is the window's, stream 1 the
warm-up's.
"""

import numpy as np


class Starts:
    def __init__(self, traffic, base, seed, stream=0):
        if traffic["perturb"] not in ("relative", "additive"):
            raise ValueError(f"unknown perturbation {traffic['perturb']!r}")
        self.base = np.asarray(base, np.float64)
        self.relative = traffic["perturb"] == "relative"
        self.scale = float(traffic["scale"])
        self.lanes = int(traffic["lanes"])
        self.rng = np.random.default_rng([int(seed) % 2 ** 64, int(stream)])

    def next(self):
        """(lanes, n) starts of the next unit."""
        z = self.rng.standard_normal((self.lanes, self.base.size))
        if self.relative:
            return self.base * (1.0 + self.scale * z)
        return self.base + self.scale * z
