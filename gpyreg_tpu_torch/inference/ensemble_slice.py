"""Ensemble slice sampling of a density that lives on the device, with
the chain driven from the host.

Port of ``gpyreg_tpu/inference/ensemble_slice.py``: ``diagnose_ensemble``
(:44-101), the masked density (:104-111), the complementary half-ensemble
step ``_eis_step`` (:114-205) with its ``max_shrink`` cap exit (:164-169),
``_run`` (:208-235) and ``sample`` (:301-434).  The MATLAB oracle's
ensemble MCMC (eissample_lite.m, transition transSliceSampleRD
:938-998): each walker slice samples along the difference of two other
walkers, ``w = (x_r2 - x_r1) * sigma_factor``, an affine-invariant,
gradient-free move.  The walkers form two halves updated in turn; every
walker of the active half draws its direction from the frozen half.

The move of a walker along w from x: level = logP + log(u); bracket t in
[-r, 1 - r]; shrink on rejection; out of bounds and NaN are -inf
(eissample_lite.m's logPfuns contract).  At the shrink cap the walker
keeps its position and density.

The JAX chain moves the walkers of a half in one ``vmap``: one batched
density a shrinkage round, and a walker that is done keeps its state
while the others go on.  Here the walkers of a half move one after the
other, each with its own stream, which is the same chain; each density
is one call of ``log_f`` (``log_post_chain_raw`` in ``GP.fit``) on the
GP's device, its value pulled as a float, and a point outside the bounds
is -inf without a call.  The positions stay on the host in float64.  The
stream's :meth:`~.device_slice.TorchStream.fill`,
:meth:`~.device_slice.TorchStream.ensemble_iteration` and
:meth:`~.device_slice.TorchStream.half_move` follow the JAX key tree.

Left out, with the JAX package's lines:

- ``_log_prior_batch_fn`` (:36-41): the port evaluates one prior a
  sample, as ``sampling.sample_log_priors`` does;
- for good, being TPU-only: the segmented chain ``_eis_init``,
  ``_eis_seg`` and ``_run_segmented`` (:238-300) and ``sample``'s
  ``seg_iters``.
"""

import logging
import math

import numpy as np
import torch

from ..slice_sample import effective_n, gelman_rubin
from .device_slice import _as_stream, _expand, _masked_log_f

_logger = logging.getLogger("EnsembleSliceSampler")


def diagnose_ensemble(chain_x, n_requested: int):
    """Cross-walker convergence diagnostics of an ensemble chain.

    ``chain_x`` is the post-burn (n_iters, K, D) walker history.  Every
    walker is a chain of the same density, so the multi-chain
    Gelman-Rubin R-hat and effective N apply to the walkers (exit flags
    as reference slice_sample.py:604-647: 1 converged, -3 max R > 1.5,
    -2 max R > 1.1, -1 eff_N < requested / 10, 0 unknown).  Where the
    variogram estimator of eff_N comes up empty on very short walker
    chains, the independent-draw count K * n_iters stands in.
    """
    n_iters, K, _ = chain_x.shape
    if n_iters < 2 or K < 2:
        return 0, None, None
    chains = np.transpose(np.asarray(chain_x), (1, 0, 2))  # (K, n, D)
    R = gelman_rubin(chains)
    eff_N = effective_n(chains)
    eff_N = np.where(
        np.isfinite(eff_N) & (eff_N > 0), eff_N, float(K * n_iters)
    )

    exit_flag = 0
    if np.any(R > 1.5):
        _logger.info(
            " * Detected lack of convergence! (max R = %.2f >> 1, "
            "mean R = %.2f)",
            np.max(R),
            np.mean(R),
        )
        exit_flag = -3
    elif np.any(R > 1.1):
        _logger.info(
            " * Detected probable lack of convergence! (max R = %.2f > 1"
            ", mean R = %.2f)",
            np.max(R),
            np.mean(R),
        )
        exit_flag = -2
    if np.any(eff_N < n_requested / 10.0):
        _logger.info(
            " * Low number of effective samples! (min eff_N = %.1f, "
            "mean eff_N = %.1f, requested N = %d)",
            np.min(eff_N),
            np.mean(eff_N),
            n_requested,
        )
        if exit_flag == 0:
            exit_flag = -1
    if exit_flag == 0:
        exit_flag = 1
    return exit_flag, R, eff_N


def _slice_1d(logpdf, x, logP, w, mv, max_shrink):
    """One slice move of a walker along direction ``w`` from ``x``
    (``slice_1d``, :120-169).  Returns (new position, its density)."""
    log_uprime = logP + math.log(mv.level())
    rr = mv.position()
    t_l, t_r = -rr, 1.0 - rr
    t, logPp = 0.0, logP
    shrink, done = 0, False
    while not done and shrink < max_shrink:
        t = mv.proposal() * (t_r - t_l) + t_l
        logPp = logpdf(x + t * w)
        accept = logPp > log_uprime
        if not accept and t > 0.0:
            t_r = t
        if not accept and t < 0.0:
            t_l = t
        shrink += 1
        done = accept or t == 0.0
    if not done:
        # Cap exit: the last proposal was rejected, so the walker keeps
        # its position and density (cf. device_slice's cap exit).
        t, logPp = 0.0, logP
    return x + t * w, logPp


def _half_move(logpdf, active_x, active_logP, frozen_x, stream, max_shrink,
               sigma_factor):
    """Move one half-ensemble, each walker along the difference of two
    distinct walkers of the frozen half (``update_half``, :171-185;
    eissample_lite.m:957-962)."""
    n, H = active_x.shape[0], frozen_x.shape[0]
    i1, off, moves = stream.half_move(n, H)
    i2 = (i1 + off) % H
    w = (frozen_x[i2] - frozen_x[i1]) * sigma_factor
    xs = np.empty_like(active_x)
    logPs = np.empty_like(active_logP)
    for i in range(n):
        xs[i], logPs[i] = _slice_1d(logpdf, active_x[i], active_logP[i], w[i],
                                    moves[i], max_shrink)
    return xs, logPs


def _run(logpdf, xs, logPs, stream, n_iters, max_shrink, sigma_factor):
    """``n_iters`` iterations, each moving the first half against the
    second, then the second against the moved first (``step``,
    :187-195).  Returns the walker history (n_iters, K, D) and its
    densities (n_iters, K)."""
    K, D = xs.shape
    H = K // 2
    chain_x = np.empty((n_iters, K, D))
    chain_logP = np.empty((n_iters, K))
    for it in range(n_iters):
        s_a, s_b = stream.ensemble_iteration()
        xA, lA = _half_move(logpdf, xs[:H], logPs[:H], xs[H:], s_a,
                            max_shrink, sigma_factor)
        xB, lB = _half_move(logpdf, xs[H:], logPs[H:], xA, s_b,
                            max_shrink, sigma_factor)
        xs = np.concatenate([xA, xB])
        logPs = np.concatenate([lA, lB])
        chain_x[it], chain_logP[it] = xs, logPs
    return chain_x, chain_logP


def sample(
    log_f,
    x0,
    key,
    n_samples: int,
    n_walkers: int = None,
    widths=None,
    LB=None,
    UB=None,
    burn: int = None,
    thin: int = 1,
    sigma_factor: float = 5.0,
    max_shrink: int = 256,
    f_args=(),
    log_prior=None,
    diagnostics: bool = True,
):
    """Draw ``n_samples`` from ``log_f`` with ensemble slice sampling.

    As eissample_lite.m:1-86: ``x0`` is a point or a (m, D) stack of
    walkers; missing walkers are copies of the given ones, jittered by
    0.1 ``widths`` (half the bound span, or 10 where it is infinite, by
    default) and clipped to the bounds; the ensemble has K = 2 (D + 1)
    walkers by default, at least 4 and rounded up to even.  ``burn``
    (default ceil(n_samples / 3)) counts iterations, each of which moves
    every walker once; the kept iterations' walkers are flattened
    iteration-major and thinned by ``thin``.

    ``log_f`` is called as ``log_f(x, *f_args)`` with ``x`` a float64 CPU
    tensor (D,) and returns a scalar log density (prior included); ``key``
    is a stream (:func:`~.device_slice.make_stream`) or an integer seed.
    ``log_prior`` (optional, ``(x, *f_args) -> scalar``) is reported per
    sample in ``log_priors`` and subtracted from ``f_vals``.  With
    ``diagnostics``, the cross-walker R-hat, effective N and exit flag of
    :func:`diagnose_ensemble`.

    Returns ``(result, final walker positions (K, D))``.
    """
    x0 = np.atleast_2d(np.asarray(x0, dtype=np.float64))
    D = x0.shape[1]
    if n_walkers is None:
        n_walkers = 2 * (D + 1)
    n_walkers = max(4, n_walkers + (n_walkers % 2))
    LBa = _expand(LB, -np.inf, D)
    UBa = _expand(UB, np.inf, D)
    if np.any(x0 < LBa) or np.any(x0 > UBa):
        raise ValueError(
            "The initial starting point X0 is outside the bounds."
        )
    w = _expand(widths, np.nan, D)
    fin = np.isfinite(LBa) & np.isfinite(UBa)
    w = np.where(np.isnan(w), np.where(fin, (UBa - LBa) / 2.0, 10.0), w)

    # Build the ensemble: keep the given rows, jitter copies to fill.
    stream = _as_stream(key)
    need = n_walkers - x0.shape[0]
    jitter = stream.fill(max(need, 0), D)
    if need <= 0:
        ens = x0[:n_walkers].copy()
    else:
        base = x0[np.arange(need) % x0.shape[0]]
        ens = np.concatenate([x0, base + 0.1 * w * jitter])
    ens = np.minimum(np.maximum(ens, LBa), UBa)

    if burn is None:
        burn = int(np.ceil(n_samples / 3))
    n_iters = burn + -(-(n_samples * thin) // n_walkers)

    logpdf = _masked_log_f(log_f, LBa, UBa, tuple(f_args))
    logP0 = np.array([logpdf(e) for e in ens])
    if not np.all(np.isfinite(logP0)):
        raise ValueError(
            "The initial starting points must evaluate to a real number "
            "(not Inf or NaN)."
        )
    chain_x, chain_logP = _run(logpdf, ens, logP0, stream, int(n_iters),
                               int(max_shrink), float(sigma_factor))

    chain_keep = chain_x[burn:]  # (n_keep_iters, K, D)
    kept_x = chain_keep.reshape(-1, D)[::thin][:n_samples]
    kept_l = chain_logP[burn:].reshape(-1)[::thin][:n_samples]
    if log_prior is not None:
        log_priors = np.array([
            float(log_prior(torch.tensor(s), *f_args)) for s in kept_x
        ])
        # The chain carries the full density; the reported values
        # exclude the prior (reference result contract).
        f_vals = kept_l - log_priors
    else:
        log_priors = np.zeros((kept_x.shape[0],))
        f_vals = kept_l

    if diagnostics:
        exit_flag, R, eff_N = diagnose_ensemble(chain_keep,
                                                n_requested=n_samples)
    else:
        exit_flag, R, eff_N = 0, None, None

    result = {
        "samples": kept_x,
        "f_vals": f_vals.reshape(-1, 1),
        "log_priors": log_priors,
        "exit_flag": exit_flag,
        "R": R,
        "eff_N": eff_N,
    }
    return result, chain_x[-1]
