"""Dense linear algebra of the serving path, on a leading batch axis.

Port of the forward subset of ``gpyreg_tpu/ops/linalg.py``:
``_chol_of`` (:127-141) and ``_jittered_chol_impl`` (:483-527) as
:func:`jittered_cholesky`, ``chol_solve`` (:476), the value of
``quad_logdet`` (:530-555) and ``neg_inverse_from_chol`` (:593-630).
The factorizations and solves are cuSOLVER/cuBLAS (LAPACK on the CPU)
through ``torch.linalg``.

Left out until the NLML-gradient slice: the ``jittered_cholesky`` VJP
(:428-473) and the ``quad_logdet`` VJP (:558-590).  Left out for good,
because they exist for a TPU whose triangular solve is slow (:163-176):
``blocked_cholesky`` / ``recursive_cholesky`` (:24-125), ``tri_inv``,
``sym_tri_product``, ``tri_lower_matmul`` and ``_GINV_MODE``
(:163-425), and the column-chunked inverse of ``neg_inverse_from_chol``
(:615-630), which bounds XLA's solve temporaries.
"""

import torch

from .._config import CHOL_MAX_TRIES


def _diag(A):
    return A.diagonal(dim1=-2, dim2=-1)


def _each(fn, *args):
    """``fn`` applied to each matrix of the leading batch axis, results
    written into one preallocated output.  Batched solver calls index
    the whole batch with 32-bit offsets: eight 16384^2 matrices span
    2.1e9 elements, and ``torch.cholesky_solve`` over them fails with
    "invalid argument" on the card, so every (N, N) batch goes one
    matrix at a time."""
    first = fn(*(a[0] for a in args))
    out = first.new_empty((args[0].shape[0],) + first.shape)
    out[0] = first
    del first
    for i in range(1, args[0].shape[0]):
        out[i] = fn(*(a[i] for a in args))
    return out


def jittered_cholesky(K, sn2_vec):
    """Factorize ``G(m) = K + m*diag(sn2)`` for the smallest working m.

    ``K`` is (..., N, N) and ``sn2_vec`` broadcasts to (..., N).  m runs
    over {1, 10, ..., 10**(CHOL_MAX_TRIES-1)}; each matrix of the batch
    escalates on its own with its own m, as the vmapped ``while_loop`` of
    the JAX package does.  Failure is read from ``cholesky_ex``'s
    ``info``.  Returns ``(L, m)``: the lower factors (..., N, N), all-NaN
    for a matrix on which every attempt failed, and the multipliers (...).

    ``K`` is overwritten with G(1): at N = 16384 every (N, N) copy is
    1 GB per sample, and K is not needed afterwards.
    """
    N = K.shape[-1]
    batch = K.shape[:-2]
    Kb = K.reshape(-1, N, N)
    sn2 = torch.broadcast_to(sn2_vec, batch + (N,)).reshape(-1, N)
    B = Kb.shape[0]
    diag_k = _diag(Kb).clone()
    _diag(Kb).add_(sn2)
    L = torch.empty_like(Kb)
    info = torch.empty((B,), dtype=torch.int32, device=K.device)
    for i in range(B):  # one matrix at a time, see _each
        L[i], info[i] = torch.linalg.cholesky_ex(Kb[i])
    mult = torch.ones((B,), dtype=K.dtype, device=K.device)
    bad = info != 0
    tries = 1
    while tries < CHOL_MAX_TRIES and bool(bad.any()):
        for i in torch.nonzero(bad).flatten().tolist():
            mult[i] = mult[i] * 10.0
            G = Kb[i].clone()
            # Same diagonal as K + m*diag(sn2); the off-diagonal is K's.
            _diag(G).copy_(diag_k[i] + mult[i] * sn2[i])
            L[i], info[i] = torch.linalg.cholesky_ex(G)
            del G
        bad = info != 0
        tries += 1
    if bool(bad.any()):
        L[bad] = float("nan")
    return L.reshape(K.shape), mult.reshape(batch)


def chol_solve(L, b):
    """Solve (L L^T) x = b given lower Cholesky factors (one, or a
    batch on the leading axis)."""
    if L.ndim == 2:
        return torch.cholesky_solve(b, L, upper=False)
    return _each(chol_solve, L, b.expand(L.shape[:-2] + b.shape[-2:]))


def quad_logdet(K, sn2_vec, r):
    """The value of the NLML's factorize+solve+logdet block: factor
    G = K + mult*diag(sn2) with jitter escalation and return
    ``(r^T G^{-1} r, sum(log diag L), mult)``, batched over leading
    axes.  ``K`` is overwritten (see :func:`jittered_cholesky`)."""
    L, mult = jittered_cholesky(K, sn2_vec)
    alpha = chol_solve(L, r)
    quad = torch.sum(r * alpha, dim=(-2, -1))
    halflogdet = torch.sum(torch.log(_diag(L)), dim=-1)
    return quad, halflogdet, mult


def neg_inverse_from_chol(L):
    """-(L L^T)^{-1} from lower Cholesky factors (batched): the
    reference's low-noise explicit-inverse parametrization
    (gaussian_process.py:2440-2448) and the fast_predict path."""
    if L.ndim == 2:
        return -torch.cholesky_inverse(L, upper=False)
    return _each(neg_inverse_from_chol, L)
