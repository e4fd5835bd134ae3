"""Hyperprior log-density as a differentiable PyTorch function.

Port of ``gpyreg_tpu/core/priors.py`` (the whole module, :1-159).  Four
prior families per hyperparameter (gaussian, student_t, smoothbox,
smoothbox_student_t) plus fixed (LB == UB) and improper-uniform, chosen
by the finiteness pattern of the prior table (reference
gaussian_process.py:1275-1466).  The family masks are computed on the
host into a :class:`PriorPack` of tensors; :func:`log_prior` is one
where-masked expression whose gradient comes from autograd.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

_LOG_2PI = math.log(2.0 * math.pi)


class PriorPack(NamedTuple):
    """Prior table and family masks as tensors on one device."""

    mu: torch.Tensor
    sigma: torch.Tensor  # abs() applied
    df: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    f_mask: torch.Tensor  # fixed: lb == ub
    sb_mask: torch.Tensor  # smoothbox
    sbt_mask: torch.Tensor  # smoothbox student-t
    g_mask: torch.Tensor  # gaussian
    t_mask: torch.Tensor  # student-t
    log_norm: torch.Tensor  # sum(log(normalization_constants)), scalar


def build_prior_pack(hyper_priors, lower_bounds, upper_bounds, log_norm=0.0,
                     device="cpu"):
    """A float64 :class:`PriorPack` on ``device`` from the host-side prior
    table; the masks follow reference gaussian_process.py:1289-1312."""
    mu = np.asarray(hyper_priors["mu"], dtype=np.float64)
    sigma = np.abs(np.asarray(hyper_priors["sigma"], dtype=np.float64))
    df = np.asarray(hyper_priors["df"], dtype=np.float64)
    a = np.asarray(hyper_priors["a"], dtype=np.float64)
    b = np.asarray(hyper_priors["b"], dtype=np.float64)
    lb = np.asarray(lower_bounds, dtype=np.float64)
    ub = np.asarray(upper_bounds, dtype=np.float64)

    fin = np.isfinite
    f_mask = lb == ub
    df_gauss = (df == 0) | ~fin(df)
    sb_mask = fin(a) & fin(b) & df_gauss & ~fin(mu) & fin(sigma)
    sbt_mask = fin(a) & fin(b) & (df > 0) & ~fin(mu) & fin(sigma) & fin(df)
    u_mask = ~fin(mu) & ~fin(sigma)
    g_mask = ~u_mask & ~sb_mask & df_gauss & fin(sigma)
    t_mask = ~u_mask & ~sbt_mask & (df > 0) & fin(df)

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=device)

    # NaN-safe substitutions, so that masked-out lanes cannot poison a
    # gradient through torch.where.
    any_loc = sb_mask | sbt_mask | g_mask | t_mask
    return PriorPack(
        mu=dev(np.where(g_mask | t_mask, mu, 0.0)),
        sigma=dev(np.where(any_loc, sigma, 1.0)),
        df=dev(np.where(sbt_mask | t_mask, df, 1.0)),
        a=dev(np.where(sb_mask | sbt_mask, a, 0.0)),
        b=dev(np.where(sb_mask | sbt_mask, b, 0.0)),
        lb=dev(np.where(np.isfinite(lb), lb, 0.0)),
        ub=dev(np.where(np.isfinite(ub), ub, 0.0)),
        f_mask=dev(f_mask),
        sb_mask=dev(sb_mask),
        sbt_mask=dev(sbt_mask),
        g_mask=dev(g_mask),
        t_mask=dev(t_mask),
        log_norm=dev(np.float64(log_norm)),
    )


def log_prior(pack: PriorPack, hyp):
    """Truncation-normalized log prior density of one hyperparameter
    vector (reference __compute_log_priors, gaussian_process.py:1275-1466);
    -inf when a fixed hyperparameter leaves its pinned value.  ``hyp``
    is a tensor on the pack's device, float64."""
    mu, sigma, df, a, b = pack.mu, pack.sigma, pack.df, pack.a, pack.b
    gammaln = torch.special.gammaln

    z2 = ((hyp - mu) / sigma) ** 2

    lp_g = -0.5 * (_LOG_2PI + 2.0 * torch.log(sigma) + z2)

    t_norm = (
        gammaln(0.5 * (df + 1.0))
        - gammaln(0.5 * df)
        - 0.5 * torch.log(math.pi * df)
        - torch.log(sigma)
    )
    lp_t = t_norm - 0.5 * (df + 1.0) * torch.log1p(z2 / df)

    # Smoothbox: gaussian flanks, flat core.
    C_sb = 1.0 + (b - a) / (sigma * math.sqrt(2.0 * math.pi))
    below = hyp < a
    above = hyp > b
    out = below | above
    edge = torch.where(below, a, b)
    z2_sb = torch.where(out, ((hyp - edge) / sigma) ** 2, torch.zeros_like(hyp))
    lp_sb_out = -0.5 * (
        torch.log(C_sb**2) + _LOG_2PI + 2.0 * torch.log(sigma) + z2_sb
    )
    lp_sb_in = -(torch.log(C_sb * sigma) + 0.5 * _LOG_2PI)
    lp_sb = torch.where(out, lp_sb_out, lp_sb_in)

    # Smoothbox student-t: t flanks, flat core.
    c_t = torch.exp(
        gammaln(0.5 * (df + 1.0))
        - gammaln(0.5 * df)
        - torch.log(sigma)
        - 0.5 * torch.log(df * math.pi)
    )
    C_sbt = 1.0 + (b - a) * c_t
    lp_sbt_in = (
        gammaln(0.5 * (df + 1.0))
        - gammaln(0.5 * df)
        - 0.5 * torch.log(math.pi * df)
        - torch.log(C_sbt * sigma)
    )
    lp_sbt_out = lp_sbt_in - 0.5 * (df + 1.0) * torch.log1p(z2_sb / df)
    lp_sbt = torch.where(out, lp_sbt_out, lp_sbt_in)

    zero = torch.zeros_like(hyp)
    per_dim = (
        torch.where(pack.g_mask, lp_g, zero)
        + torch.where(pack.t_mask, lp_t, zero)
        + torch.where(pack.sb_mask, lp_sb, zero)
        + torch.where(pack.sbt_mask, lp_sbt, zero)
    )
    lp = torch.sum(per_dim) - pack.log_norm

    # Fixed hyperparameters: -inf off the pinned value
    # (reference gaussian_process.py:1321-1325).
    bad_fixed = torch.any(pack.f_mask & (hyp != pack.lb))
    return torch.where(bad_fixed, torch.full_like(lp, -math.inf), lp)
