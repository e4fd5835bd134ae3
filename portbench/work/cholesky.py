"""Operations of the dense factorizations and solves at order n, as
LAPACK counts them: potrf n^3/3 + n^2/2 + n/6; the inverse from the
factor (trtri then lauum) 2n^3/3 + n^2/2 + n/6 to leading order; a
triangular solve n^2 a right-hand side."""


def potrf(n):
    return n**3 / 3 + n**2 / 2 + n / 6


def potri(n):
    return 2 * n**3 / 3 + n**2 / 2 + n / 6


def trsv(n, rhs=1):
    return n * n * rhs
