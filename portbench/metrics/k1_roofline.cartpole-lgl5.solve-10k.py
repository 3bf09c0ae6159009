"""k1_roofline.cartpole-lgl5.solve-10k: K1's bound over its device time
in the cell's host-traced solves, every K1 launch counted: the
`_inv_sym` calls seen on the host and the launches replayed from CUDA
graphs (`portbench/k1_replay.py`)."""

from portbench.k1_replay import k1_roofline


def read(run):
    return k1_roofline(run, "cartpole-lgl5.solve-10k")
