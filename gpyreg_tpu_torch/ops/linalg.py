"""Dense linear algebra of the NLML and the posterior, on a leading
batch axis.

Port of ``gpyreg_tpu/ops/linalg.py``: ``_chol_of`` (:127-141) and
``_jittered_chol_impl`` (:483-527) with the ``jittered_cholesky`` VJP
(``_cholesky_vjp_core``, :428-473) as :func:`jittered_cholesky`,
``chol_solve`` (:476), ``quad_logdet`` with its VJP (:530-590),
``neg_inverse_from_chol`` (:593-630) and ``robust_cholesky``
(:633-662).  The factorizations and solves are cuSOLVER/cuBLAS (LAPACK
on the CPU) through ``torch.linalg``.  The two
VJPs are ``torch.autograd.Function``s; G^-1 of the ``quad_logdet``
adjoint comes from ``torch.cholesky_inverse``, one matrix at a time, and
the adjoint is formed in place in that buffer.

Left out for good, because they exist for a TPU whose triangular solve
is slow (:163-176): ``blocked_cholesky`` / ``recursive_cholesky`` (:24-125),
``tri_inv``, ``sym_tri_product``, ``tri_lower_matmul``,
``_ginv_from_chol_f32`` and ``_GINV_MODE`` (:163-425), the float32
``tri_inv`` branch of ``_cholesky_vjp_core`` (:444-448), and the
column-chunked inverse of ``neg_inverse_from_chol`` (:615-630), which
bounds XLA's solve temporaries.
"""

import torch

from .._config import CHOL_MAX_TRIES
from ..tracing import span


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


def _jittered_cholesky_impl(K, sn2_vec):
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
    with span("gpyreg.chol"):
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
        for _ in range(1, CHOL_MAX_TRIES):
            with span("gpyreg.sync.chol_retry"):
                if not bool(bad.any()):
                    break
            with span("gpyreg.chol.retry"):
                with span("gpyreg.sync.chol_rows"):
                    rows = torch.nonzero(bad).flatten().tolist()
                for i in rows:
                    mult[i] = mult[i] * 10.0
                    G = Kb[i].clone()
                    # Same diagonal as K + m*diag(sn2); the off-diagonal
                    # is K's.
                    _diag(G).copy_(diag_k[i] + mult[i] * sn2[i])
                    L[i], info[i] = torch.linalg.cholesky_ex(G)
                    del G
                bad = info != 0
        with span("gpyreg.sync.chol_failed"):
            failed = bool(bad.any())
        if failed:
            L[bad] = float("nan")
        return L.reshape(K.shape), mult.reshape(batch)


def _cholesky_vjp_core(L, L_bar):
    """Adjoint of A -> L = cholesky(A) (lower), one matrix:
    A_bar = L^-T Phi(L^T L_bar) L^-1, symmetrized, where Phi takes the
    lower triangle with the diagonal halved.  Two N-wide triangular
    solves, the float64 branch of ``gpyreg_tpu/ops/linalg.py:449-454``."""
    P = torch.tril(L.mT @ L_bar)
    _diag(P).mul_(0.5)
    X = torch.linalg.solve_triangular(L.mT, P, upper=True)  # L^-T P
    del P
    A = torch.linalg.solve_triangular(L, X, upper=False, left=False)  # X L^-1
    del X
    return 0.5 * (A + A.mT)


class JitteredCholesky(torch.autograd.Function):
    """:func:`_jittered_cholesky_impl` with its VJP.  ``K`` is overwritten
    with G(1), so it is marked dirty and returned as a third output,
    which has no gradient.  ``mult`` is piecewise constant: no gradient
    (``gpyreg_tpu/ops/linalg.py:462-470``)."""

    @staticmethod
    def forward(ctx, K, sn2_vec):
        L, mult = _jittered_cholesky_impl(K, sn2_vec)
        ctx.mark_dirty(K)
        ctx.mark_non_differentiable(mult, K)
        ctx.save_for_backward(L, mult)
        ctx.sn2_shape = sn2_vec.shape
        ctx.set_materialize_grads(False)
        return L, mult, K

    @staticmethod
    def backward(ctx, L_bar, _mult_bar, _K_bar):
        L, mult = ctx.saved_tensors
        if L_bar is None:
            return None, None
        N = L.shape[-1]
        A_bar = _each(_cholesky_vjp_core, L.reshape(-1, N, N),
                      L_bar.reshape(-1, N, N)).reshape(L.shape)
        sn2_bar = mult[..., None] * _diag(A_bar)
        return A_bar, sn2_bar.sum_to_size(ctx.sn2_shape)


def jittered_cholesky(K, sn2_vec):
    """Factorize ``G(m) = K + m*diag(sn2)`` for the smallest working m;
    returns ``(L, mult)`` (see :func:`_jittered_cholesky_impl`), with a
    gradient for ``K`` and ``sn2_vec``.  ``K`` is overwritten with G(1)."""
    L, mult, _ = JitteredCholesky.apply(K, sn2_vec)
    return L, mult


def chol_solve(L, b):
    """Solve (L L^T) x = b given lower Cholesky factors (one, or a
    batch on the leading axis)."""
    with span("gpyreg.solve"):
        if L.ndim == 2:
            return torch.cholesky_solve(b, L, upper=False)
        return _each(lambda Li, bi: torch.cholesky_solve(bi, Li, upper=False),
                     L, b.expand(L.shape[:-2] + b.shape[-2:]))


class QuadLogdet(torch.autograd.Function):
    """``quad_logdet`` of one matrix with the analytic VJP of
    ``gpyreg_tpu/ops/linalg.py:566-587``:

        G_bar = 0.5 * h_bar * G^-1 - q_bar * alpha alpha^T,
        K_bar = G_bar,  sn2_bar = mult * diag(G_bar),  r_bar = 2 q_bar alpha.

    ``K`` is overwritten with G(1) (marked dirty, returned as a fourth
    output without a gradient).  The backward holds L and one (N, N)
    buffer: ``torch.cholesky_inverse`` writes G^-1, which is scaled and
    given the rank-one term in place and handed on as K_bar.
    """

    @staticmethod
    def forward(ctx, K, sn2_vec, r):
        L, mult = _jittered_cholesky_impl(K, sn2_vec)
        alpha = chol_solve(L, r)
        quad = torch.sum(r * alpha)
        halflogdet = torch.sum(torch.log(_diag(L)))
        ctx.mark_dirty(K)
        ctx.mark_non_differentiable(mult, K)
        ctx.save_for_backward(L, mult, alpha)
        ctx.sn2_shape = sn2_vec.shape
        ctx.set_materialize_grads(False)
        return quad, halflogdet, mult, K

    @staticmethod
    def backward(ctx, q_bar, h_bar, _mult_bar, _K_bar):
        L, mult, alpha = ctx.saved_tensors
        if h_bar is None:
            G_bar = torch.zeros_like(L)
        else:
            with span("gpyreg.chol_inverse"):
                G_bar = torch.cholesky_inverse(L, upper=False)
                G_bar.mul_(0.5 * h_bar)
        a = alpha.reshape(-1)
        if q_bar is not None:
            G_bar.addr_(a * -q_bar, a)
        sn2_bar = (mult * _diag(G_bar)).sum_to_size(ctx.sn2_shape)
        r_bar = None if q_bar is None else (2.0 * q_bar) * alpha
        return G_bar, sn2_bar, r_bar


def quad_logdet(K, sn2_vec, r):
    """The NLML's factorize+solve+logdet block: factor
    G = K + mult*diag(sn2) with jitter escalation and return
    ``(r^T G^{-1} r, sum(log diag L), mult)`` with the gradient of
    :class:`QuadLogdet`; a stack of matrices goes one at a time.  ``K``
    is overwritten (see :func:`_jittered_cholesky_impl`)."""
    if K.ndim == 2:
        return QuadLogdet.apply(K, sn2_vec, r)[:3]
    sn2 = sn2_vec.expand(K.shape[:-1])
    rb = r.expand(K.shape[:-2] + r.shape[-2:])
    outs = [quad_logdet(*a) for a in zip(K, sn2, rb)]
    return tuple(torch.stack(t) for t in zip(*outs))


def neg_inverse_from_chol(L):
    """-(L L^T)^{-1} from lower Cholesky factors (batched): the
    reference's low-noise explicit-inverse parametrization
    (gaussian_process.py:2440-2448) and the fast_predict path."""
    if L.ndim == 2:
        return -torch.cholesky_inverse(L, upper=False)
    return _each(neg_inverse_from_chol, L)


def robust_cholesky(sigma):
    """A factor T with T^T T = sigma (``gpyreg_tpu/ops/linalg.py:633-662``,
    reference ``__robust_cholesky``, gaussian_process.py:2331-2355).

    ``torch.linalg.cholesky_ex`` first; when it fails, the eigenvalue
    fallback: the eigenvectors' signs fixed by each column's entry of
    largest magnitude, eigenvalues below eps * max(w) * n dropped, and
    zeros when a kept eigenvalue is negative.  Returns the upper factor
    (the transposed Cholesky factor, or sqrt(w) U^T from the fallback).
    The route taken is the span ``gpyreg.robust_cholesky.cholesky`` or
    ``gpyreg.robust_cholesky.eigh``."""
    Lc, info = torch.linalg.cholesky_ex(sigma)
    if int(info) == 0:
        with span("gpyreg.robust_cholesky.cholesky"):
            return Lc.mT
    with span("gpyreg.robust_cholesky.eigh"):
        n = sigma.shape[0]
        w, U = torch.linalg.eigh(0.5 * (sigma + sigma.mT))
        cols = torch.arange(n, device=U.device)
        signs = torch.sign(U[torch.argmax(torch.abs(U), dim=0), cols])
        U = U * torch.where(signs == 0, torch.ones_like(signs), signs)[None, :]
        tol = torch.abs(torch.finfo(sigma.dtype).eps * torch.max(w)) * n
        keep = torch.abs(w) > tol
        if bool(torch.any(keep & (w < 0))):
            return torch.zeros_like(sigma)
        w_safe = torch.where(keep, torch.clamp(w, min=0.0),
                             torch.zeros_like(w))
        return torch.sqrt(w_safe)[:, None] * U.mT
