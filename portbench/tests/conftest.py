import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the small sizes at which a cell runs on the CPU
SMALL = {"cartpole-lgl5": ({"nsegs": 16}, None)}
LANES = {"ensemble": 4, "solve": None}


def small(name):
    """(overrides, lanes) of cell `name` at a CPU test's size."""
    from portbench import spec
    cell = spec.cell(spec.bench(ROOT), name)
    overrides, _ = SMALL[cell["config"]]
    return overrides, LANES[spec.workload(name)["entry"]]


@pytest.fixture
def card():
    """Skip without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
