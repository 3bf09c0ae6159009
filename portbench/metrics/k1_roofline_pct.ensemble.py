"""k1_roofline_pct.ensemble: K1's bound over the device time spent inside
`kkt_block._inv_sym`, in the traced ensemble calls."""

from portbench.readers import k1_roofline_pct


def read(run):
    return k1_roofline_pct(run)
