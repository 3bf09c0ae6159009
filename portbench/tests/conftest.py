import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small(name):
    """(overrides, lanes) of cell `name` at a CPU test's size: its
    configuration's TEST_OVERRIDES and its entry's TEST_LANES."""
    from portbench import spec
    cell = spec.cell(spec.bench(ROOT), name)
    config = spec.load_module("configs", cell["config"])
    entry = spec.load_module("entries", spec.workload(name)["entry"])
    return dict(config.TEST_OVERRIDES), entry.TEST_LANES


@pytest.fixture
def card():
    """Skip without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
