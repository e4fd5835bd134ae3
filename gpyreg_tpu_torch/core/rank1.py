"""Rank-1 posterior updates: one new data point in O(N^2) a sample.

Port of ``gpyreg_tpu/core/rank1.py``: ``chol_one`` and ``inv_one``
(:82-137), the reference's single-point update (gaussian_process.py:
737-844), with the same math and the same ``ok`` rules, the predictive
mean and variance at the new point (with observation noise) computed
inside the update from the same cross-covariance.

Math (Cholesky parametrization; L is the upper factor of the
sn2-scaled matrix): with k* the cross-covariance against the new point
and c = L^-T k*,

    sqrt_arg = sn2_eff^2 + k(x*,x*) sn2_eff - c^T c
    L'       = [[L, c/sn2_eff], [0, sqrt(sqrt_arg)/sn2_eff]]

``sqrt_arg <= 0`` flags numerical instability, and the caller rebuilds
that sample (reference :784-798).  Explicit negative-inverse
parametrization: with u = -L k* (which equals (K + sigma^2 I)^-1 k*) and
v = -u / v*,

    L' = [[L + v u^T, -v], [-v^T, -1/v*]]

with the ``sqrt(eps)`` floor on v* that the reference lacks
(:117-128).  Both append 1/sqrt(sn2_eff) to sW and update

    alpha' = [alpha; 0] + (m* - y*)/v* * [u; -1].

The port has no padding: each factor grows by one row and column.  The
grown factor is a new (N+1)^2 tensor, the old block copied into it (in
the storage order of the old factor: the Cholesky factor is stored as
the transposed view of a lower factor), then the new column (and row);
the caller drops the old tensor before the next sample's update.
``alpha`` and ``sW`` grow the same way.  The cross-covariance k* is
built by ``core.model.cov_matrix``: the kernel tile (an N x 1 cross) for
a float32 tensor on the card.

Left out, for good: the JAX package's ``mixed`` program (:139-155),
which evaluates both parametrizations and selects one per sample; here
each sample takes its own branch.
"""

import torch

from .model import ModelSpec, cov_matrix, mean_value


def _common(spec: ModelSpec, hyp, X, x_new):
    """(k* (N,), k(x*, x*), m(x*)) of one sample, as device tensors."""
    hyp = torch.as_tensor(hyp).to(dtype=X.dtype, device=X.device)
    hyp_cov, _, hyp_mean = spec.split_hyp(hyp)
    k_star = cov_matrix(spec, hyp_cov, X, Z=x_new)[:, 0]
    k_new = cov_matrix(spec, hyp_cov, x_new, diag=True)[0]
    m_star = mean_value(spec, hyp_mean, x_new)[0]
    return k_star, k_new, m_star


def _grown(L):
    """An (N+1)^2 tensor with L in its leading block, laid out as L is
    (a transposed view stays a transposed view)."""
    N = L.shape[0]
    if L.mT.is_contiguous() and not L.is_contiguous():
        out = L.new_empty((N + 1, N + 1)).mT
    else:
        out = L.new_empty((N + 1, N + 1))
    out[:N, :N].copy_(L)
    return out


def _append(alpha, sW, upd, delta, sn2_eff):
    """alpha' = [alpha + delta upd; -delta] and sW' = [sW; 1/sqrt(sn2_eff)],
    both (N+1, 1)."""
    a = torch.cat([alpha[:, 0] + delta * upd, -delta.reshape(1)])
    w = torch.cat([sW[:, 0], (1.0 / torch.sqrt(sn2_eff)).reshape(1)])
    return a[:, None], w[:, None]


def chol_one(spec: ModelSpec, hyp, alpha, L, sW, X, x_new, y_new, sn2_eff):
    """Rank-1 update of one sample in the Cholesky parametrization.

    ``L`` (N, N) upper factor, ``alpha`` and ``sW`` (N, 1), ``X`` (N, D)
    the old data, ``x_new`` (1, D), ``y_new`` and ``sn2_eff`` 0-d tensors
    (the new point's noise times the sample's ``sn2_mult``).  Returns
    ``(L', alpha', sW', ok)`` with ``ok`` a 0-d bool tensor."""
    N = X.shape[0]
    k_star, k_new, m_star = _common(spec, hyp, X, x_new)
    L_lower = L.mT
    # Predictive moments at x_new (chol_branch + observation noise).
    m_pred = m_star + torch.sum(k_star * alpha[:, 0])
    Vc = torch.linalg.solve_triangular(
        L_lower, (sW[:, 0] * k_star)[:, None], upper=False)[:, 0]
    v_pred = torch.clamp(k_new - torch.sum(Vc * Vc), min=0.0) + sn2_eff

    c = torch.linalg.solve_triangular(L_lower, k_star[:, None],
                                      upper=False)[:, 0]
    sqrt_arg = sn2_eff**2 + k_new * sn2_eff - torch.sum(c * c)
    ok = sqrt_arg > 0
    safe = torch.clamp(sqrt_arg, min=torch.finfo(X.dtype).tiny)
    L_new = _grown(L)
    L_new[:N, N] = c / sn2_eff
    L_new[N, :N] = 0.0
    L_new[N, N] = torch.sqrt(safe) / sn2_eff
    upd = torch.linalg.solve_triangular(L, c[:, None], upper=True)[:, 0]
    upd = upd / sn2_eff
    delta = (m_pred - y_new) / v_pred
    alpha_new, sW_new = _append(alpha, sW, upd, delta, sn2_eff)
    return L_new, alpha_new, sW_new, ok


def inv_one(spec: ModelSpec, hyp, alpha, L, sW, X, x_new, y_new, sn2_eff):
    """Rank-1 update of one sample in the explicit negative-inverse
    parametrization (arguments and result as :func:`chol_one`)."""
    N = X.shape[0]
    k_star, k_new, m_star = _common(spec, hyp, X, x_new)
    Lk = L @ k_star
    # Predictive moments (inv_branch + observation noise).
    m_pred = m_star + torch.sum(k_star * alpha[:, 0])
    v_pred = torch.clamp(k_new + torch.sum(k_star * Lk), min=0.0) + sn2_eff
    # v* comes from a catastrophic cancellation (k_new + k*'(-G^-1)k*):
    # below ~sqrt(eps) of the kernel scale it carries at most half the
    # dtype's digits, and the -1/v* pivot would poison the factor.  The
    # reference checks only its Cholesky branch; the JAX package flags
    # this one too, and so does the port.
    eps = torch.finfo(X.dtype).eps
    floor = (k_new + sn2_eff + eps) * eps**0.5
    ok = v_pred > floor
    v_safe = torch.maximum(v_pred, floor)
    upd = -Lk
    v = -upd / v_safe
    L_new = _grown(L)
    L_new[:N, :N].addr_(v, upd)
    L_new[:N, N] = -v
    L_new[N, :N] = -v
    L_new[N, N] = -1.0 / v_safe
    delta = (m_pred - y_new) / v_safe
    alpha_new, sW_new = _append(alpha, sW, upd, delta, sn2_eff)
    return L_new, alpha_new, sW_new, ok
