"""One gradient-tile launch (``csrc/kernel_vjp.cu``, with its reduction):
the ARD gradient of sum(Gbar * K) at n points and width d.  It reads the
n x n cotangent and X once and writes the gradient row; it spends n^2
operations on Gbar_ij + Gbar_ji, then on each entry of one half of the
plane 3 a dimension for the squared distance, 2 more a dimension for the
ARD contraction and 6 for the profile and the sums."""

from .peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def counts(n, d):
    nbytes = 4 * (n * n + n * d + d + 2)
    ops = n * n + n * (n + 1) // 2 * (5 * d + 6)
    return nbytes, ops


def bound_s(n, d):
    nbytes, ops = counts(n, d)
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S)
