"""The JAX reference numbers of the example suite, held to the JAX
package itself.  `chip_smoke.EXAMPLES_JAX` holds, for each example at its
JAX test's call ("test") and at its full call ("full"), the flag of every
solve and the objective of every solve that optimizes, as `python
tools/port_references.py --examples` printed them; the port's mirrors
(`test_torch_examples_*.py`, `test_torch_updated_interface*.py`,
`test_torch_reentry.py`, `test_torch_fullproblems2.py`) and
`chip_smoke.py` phase 21 hold the port to them.  Here the JAX scripts
of `examples/` run at each of those calls and are held to the constants
as the port is (`chip_smoke.example_faults`), objectives to 1e-9
relative.  All of them take about 100 minutes on an 8-core CPU (JAX,
x64), so every case is `slow`."""

import pytest

from chip_smoke import EXAMPLES_JAX, example_held


@pytest.mark.slow
@pytest.mark.parametrize("key", sorted(EXAMPLES_JAX))
def test_references_are_the_jax_runs(key):
    import asset_asrl_tpu as jast
    from tools.port_references import JaxExamples
    label, size = key.rsplit(" ", 1)
    example_held(jast, label, size=size, tol=1e-9, ex=JaxExamples())
