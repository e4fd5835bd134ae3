"""The exact-GP core: model assembly, NLML value, posterior factors.

Port of ``gpyreg_tpu/core/nlml.py``: ``assemble`` (:51-94), ``gp_parts``
(:97-118), the value of ``nlz`` (:121-144) and ``posterior_factors``
(:250-270), with the ``n_real`` padding semantics (:18-24, :137-144).
One Cholesky of ``G = K + mult*diag(sn2)`` serves both of the
reference's parametrizations; the high/low-noise split
(gaussian_process.py:2404) is applied on the host when the posterior is
stored.

``gp_parts``, ``nlz`` and ``posterior_factors`` take one hyperparameter
vector (hyp_N,) or a stack (S, hyp_N): the leading sample axis replaces
``post_batch``'s ``vmap`` (:380).  ``hyp`` is cast to the data dtype
(:56), or PyTorch would promote float32 data with float64
hyperparameters to float64.

Left out until later slices: the NLML gradient (``get_fns``' grad
entries, :362-381, the fit slice), ``nlz_chain`` and ``nlz_design``
(:147-247, the samplers and the design ranking), the hyperprior
(``core/priors.py``) and output warping (:65-80; ``assemble`` raises on
a warped spec).  ``get_fns``' jitted bundle (:273-381) has no
counterpart: PyTorch runs eagerly.
"""

import math

import torch

from ..ops.linalg import chol_solve, jittered_cholesky, quad_logdet
from .model import ModelSpec, cov_matrix, mean_value, noise_variance

_LOG_2PI = math.log(2.0 * math.pi)


def _mask(N, n_real, device):
    return None if n_real is None else torch.arange(N, device=device) < n_real


def assemble(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """Model assembly for ONE hyperparameter vector: returns
    ``(K, sn2_vec, r, m)`` with the padding masks applied.

    ``n_real`` (int or None): rows >= n_real are padding.  Masking makes
    G block-diagonal ([[G_real, 0], [0, mult*I]]) with zero padded
    residual, so the real block's factor is exactly the unpadded one.
    """
    if spec.outwarp is not None:
        raise NotImplementedError(
            "Output warping is not ported yet (outwarp_functions)."
        )
    N = X.shape[0]
    hyp = torch.as_tensor(hyp).to(dtype=X.dtype, device=X.device)
    hyp_cov, hyp_noise, hyp_mean = spec.split_hyp(hyp)
    mask = _mask(N, n_real, X.device)

    sn2 = noise_variance(spec, hyp_noise, y, s2, X.dtype)
    m = mean_value(spec, hyp_mean, X)[:, None]
    K = cov_matrix(spec, hyp_cov, X)
    sn2_vec = torch.broadcast_to(torch.reshape(sn2, (-1,)), (N,))
    r = y - m
    if mask is not None:
        # In place of the JAX mask product: padded rows and columns of
        # K are zeroed without an (N, N) mask temporary.
        K[n_real:, :] = 0.0
        K[:, n_real:] = 0.0
        sn2_vec = torch.where(mask, sn2_vec, torch.ones_like(sn2_vec))
        r = torch.where(mask[:, None], r, torch.zeros_like(r))
    return K, sn2_vec, r, m


def _assemble_batch(spec, hyps, X, y, s2, n_real):
    """:func:`assemble` over a stack (S, hyp_N) into (S, ...) tensors,
    written sample by sample into one preallocated K."""
    S, N = hyps.shape[0], X.shape[0]
    K = torch.empty((S, N, N), dtype=X.dtype, device=X.device)
    sn2 = torch.empty((S, N), dtype=X.dtype, device=X.device)
    r = torch.empty((S, N, 1), dtype=X.dtype, device=X.device)
    m = torch.empty((S, N, 1), dtype=X.dtype, device=X.device)
    for s in range(S):
        Ks, sn2[s], r[s], m[s] = assemble(spec, hyps[s], X, y, s2, n_real)
        K[s] = Ks
        del Ks
    return K, sn2, r, m


def _batched(hyp, X):
    hyp = torch.as_tensor(hyp).to(dtype=X.dtype, device=X.device)
    return hyp[None] if hyp.ndim == 1 else hyp, hyp.ndim == 1


def gp_parts(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """(sn2_vec, m, L, mult, r, alpha) with L = chol(G) lower, each with
    a leading sample axis when ``hyp`` is a stack."""
    hyps, single = _batched(hyp, X)
    K, sn2_vec, r, m = _assemble_batch(spec, hyps, X, y, s2, n_real)
    L, mult = jittered_cholesky(K, sn2_vec)
    del K
    alpha = chol_solve(L, r)
    out = (sn2_vec, m, L, mult, r, alpha)
    return tuple(t[0] for t in out) if single else out


def nlz(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """Negative log marginal likelihood (value only).

    With padding, the padded rows' exact contributions (0.5*log(mult)
    per row to the log-determinant, 0.5*log(2pi) per row to the
    constant) are subtracted.
    """
    N = X.shape[0]
    hyps, single = _batched(hyp, X)
    K, sn2_vec, r, _ = _assemble_batch(spec, hyps, X, y, s2, n_real)
    quad, logdet_half, mult = quad_logdet(K, sn2_vec, r)
    if n_real is None:
        n_eff = N
    else:
        logdet_half = logdet_half - 0.5 * (N - n_real) * torch.log(mult)
        n_eff = n_real
    out = 0.5 * quad + logdet_half + 0.5 * n_eff * _LOG_2PI
    return out[0] if single else out


def posterior_factors(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """Device part of Posterior construction: (alpha, L_G_lower, mult,
    sn2_min).  The host converts these to the reference's stored-factor
    convention (upper Cholesky of the scaled matrix, or the explicit
    negative inverse) from the ``sn2_min >= 1e-6`` flag (reference
    gaussian_process.py:2404-2448).  With padding, sn2_min is taken over
    the real rows only."""
    sn2_vec, _, L, mult, _, alpha = gp_parts(spec, hyp, X, y, s2, n_real)
    mask = _mask(X.shape[0], n_real, X.device)
    if mask is not None:
        big = torch.finfo(X.dtype).max
        sn2_vec = torch.where(mask, sn2_vec, torch.full_like(sn2_vec, big))
    sn2_min = torch.amin(sn2_vec, dim=-1)
    return alpha, L, mult, sn2_min
