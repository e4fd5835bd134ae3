"""Operations of the predictive mean and variance of S samples at M
points against N rows, width D: a sample's cross tile (3 D N M), the mean
K*^T alpha (2 N M), sW K* (N M), the triangular solve (N^2 M) and the
column sums of squares (2 N M)."""

from . import cholesky, kernel_tile


def flops(N, D, M, S):
    _, tile = kernel_tile.counts(N, M, D, False)
    return S * (tile + cholesky.trsv(N, M) + 5 * N * M)
