"""Operations of one posterior build of S samples at N rows, width D:
each sample's self tile, potrf of G, and alpha by two triangular
solves."""

from . import cholesky, kernel_tile


def flops(N, D, S):
    _, tile = kernel_tile.counts(N, N, D, True)
    return S * (tile + cholesky.potrf(N) + cholesky.trsv(N, 2))
