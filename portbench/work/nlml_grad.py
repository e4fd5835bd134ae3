"""Operations of one NLML and gradient at N rows, width D: the self tile,
potrf, alpha (two solves), then the adjoint's inverse from the factor,
its rank-one term (2 N^2) and the gradient tile."""

from . import cholesky, kernel_tile, kernel_vjp


def flops(N, D):
    _, tile = kernel_tile.counts(N, N, D, True)
    _, vjp = kernel_vjp.counts(N, D)
    return (tile + cholesky.potrf(N) + cholesky.trsv(N, 2)
            + cholesky.potri(N) + 2 * N * N + vjp)
