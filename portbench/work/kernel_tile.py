"""One launch of the kernel tile (``csrc/kernel_tile.cu``): K(X, Z) for
n x m entries at width d.  It reads X and Z once and writes K once (4
bytes an entry); it spends 3 FP32 operations an entry and dimension (a
subtraction and a fused multiply-add), on one half of a self-covariance,
whose other half is the mirror.  The bound is the larger of bytes over
the memory rate and operations over the FP32 rate."""

from .peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def counts(n, m, d, self_cov):
    """(bytes, operations) of one launch; ``self_cov`` means Z is X."""
    entries = n * (n + 1) // 2 if self_cov else n * m
    return 4 * (n * m + (n + m) * d), 3 * d * entries


def bound_s(n, m, d, self_cov):
    nbytes, ops = counts(n, m, d, self_cov)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)
