"""The example suite on the port: each module is the same script as the
JAX package's `examples/` file of that name, with only its imports
changed (`tests/test_torch_examples_source.py` holds them to that).

Run one as a script, e.g.
`python -m asset_asrl_torch.examples.Brachistochrone`, or import it and
call its entry, e.g.
`from asset_asrl_torch.examples.BrysonDenham import run`.  Importing a
module solves nothing; this package imports none of them."""
