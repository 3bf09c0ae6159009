"""Peaks of one NVIDIA H100 SXM (data sheet, at its 700 W limit) and the
least time kernel K1 could take.

K1 (`kkt_block._inv_sym`) inverts K symmetric W x W blocks in float64 and
counts each block's bad pivots.  Its bound is the larger of the bytes it
must move once (D in and Dinv out, K W^2 8 bytes each; the pivots, K W 8
bytes; the counts, K 4 bytes) over the memory rate, and 2 W^3 operations
a block over the FP64 peak.
"""

PEAK_BYTES = 3.35e12        # bytes/s, HBM3
PEAK_FLOPS_F64 = 67e12      # FP64 through the tensor cores


def k1_bound(K, W, itemsize=8):
    """(seconds, "bytes" or "operations") of K1 on a (K, W, W) batch."""
    t_bytes = (K * W * (2 * W + 1) * itemsize + 4 * K) / PEAK_BYTES
    t_ops = 2.0 * K * W ** 3 / PEAK_FLOPS_F64
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
