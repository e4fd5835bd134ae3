"""The exact-GP core: model assembly, NLML with its gradient, posterior
factors.

Port of ``gpyreg_tpu/core/nlml.py``: ``assemble`` (:51-94), ``gp_parts``
(:97-118), ``nlz`` with its gradient (:121-144), ``nlz_chain``
(:147-218), ``nlz_design`` (:221-247), ``posterior_factors`` (:250-270)
and ``get_fns`` (:273-381), with the ``n_real`` padding semantics
(:18-24, :137-144).  One Cholesky of ``G = K + mult*diag(sn2)`` serves
both of the reference's parametrizations; the high/low-noise split
(gaussian_process.py:2404) is applied on the host when the posterior is
stored.

``gp_parts``, ``nlz``, ``nlz_chain``, ``nlz_design`` and
``posterior_factors`` take one hyperparameter vector (hyp_N,) or a stack
(S, hyp_N): the leading sample axis replaces ``vmap``.  The gradient of
one vector comes from autograd through ``ops.linalg.QuadLogdet`` and the
covariance (``KernelSelfFused`` on the card); a stack of vectors is
differentiated one lane at a time (:func:`value_and_grad`), since
``torch.func.vmap`` cannot batch the custom Functions or the kernels'
ctypes launches.  ``hyp`` is cast to the data dtype (:56), or PyTorch
would promote float32 data with float64 hyperparameters to float64;
gradients come back in float64, the dtype of the host's vectors.

With output warping (``spec.outwarp``, :65-80) the GP models g(y):
``assemble`` warps ``y``, hands the noise function the original ``y``
with the user variance ``s2 * g'(y)^2``, and returns the log-Jacobian
``sum(log |g'(y)|)``, which every NLML here subtracts (gplite_core.m:115).
Its gradient in the warp hyperparameters comes from autograd; the
kernel's still goes through ``KernelSelfFused``.  ``get_fns``' jitted
bundle becomes a plain dict of eager functions under the same keys; its
``lru_cache`` is not needed.
"""

import math

import torch

from .._config import CHOL_MAX_TRIES
from ..ops.linalg import chol_solve, factor_ex, jittered_cholesky, quad_logdet
from ..outwarp_functions import warp_value_and_dt
from ..tracing import span, to_device
from .model import ModelSpec, cov_matrix, mean_value, noise_variance
from .priors import log_prior

_LOG_2PI = math.log(2.0 * math.pi)


def _mask(N, n_real, device):
    return None if n_real is None else torch.arange(N, device=device) < n_real


def _cov_masked(spec, hyp_cov, X, n_real):
    """K with the padded rows and columns zeroed in place, without the
    JAX package's (N, N) mask product."""
    K = cov_matrix(spec, hyp_cov, X)
    if n_real is not None:
        K[n_real:, :] = 0.0
        K[:, n_real:] = 0.0
    return K


def assemble(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """Model assembly for ONE hyperparameter vector: returns
    ``(K, sn2_vec, r, m, log_jacobian)`` with the padding masks applied.

    ``n_real`` (int or None): rows >= n_real are padding.  Masking makes
    G block-diagonal ([[G_real, 0], [0, mult*I]]) with zero padded
    residual, so the real block's factor is exactly the unpadded one.
    The padded rows are selected with ``where``, never multiplied by the
    mask: at extreme warp hyperparameters a padded row's warped value or
    log-slope can be infinite, and inf * 0 is NaN.
    """
    with span("gpyreg.assemble"):
        N = X.shape[0]
        hyp = torch.as_tensor(hyp).to(dtype=X.dtype, device=X.device)
        hyp_cov, hyp_noise, hyp_mean = spec.split_hyp(hyp)
        mask = _mask(N, n_real, X.device)

        log_jacobian = torch.zeros((), dtype=X.dtype, device=X.device)
        y_eff, s2_eff = y, s2
        if spec.outwarp is not None:
            y_eff, dwarp = warp_value_and_dt(spec.outwarp,
                                             spec.outwarp_hyp(hyp), y)
            if s2 is not None:
                s2_eff = s2 * dwarp**2
            log_jac_terms = torch.log(torch.abs(dwarp))
            if mask is not None:
                log_jac_terms = torch.where(mask[:, None], log_jac_terms,
                                            torch.zeros_like(log_jac_terms))
            log_jacobian = torch.sum(log_jac_terms)

        sn2 = noise_variance(spec, hyp_noise, y, s2_eff, X.dtype)
        m = mean_value(spec, hyp_mean, X)[:, None]
        K = _cov_masked(spec, hyp_cov, X, n_real)
        sn2_vec = torch.broadcast_to(torch.reshape(sn2, (-1,)), (N,))
        r = y_eff - m
        if mask is not None:
            sn2_vec = torch.where(mask, sn2_vec, torch.ones_like(sn2_vec))
            r = torch.where(mask[:, None], r, torch.zeros_like(r))
        return K, sn2_vec, r, m, log_jacobian


def _assemble_batch(spec, hyps, X, y, s2, n_real):
    """:func:`assemble` over a stack (S, hyp_N) into (S, ...) tensors,
    written sample by sample into one preallocated K."""
    S, N = hyps.shape[0], X.shape[0]
    K = torch.empty((S, N, N), dtype=X.dtype, device=X.device)
    sn2 = torch.empty((S, N), dtype=X.dtype, device=X.device)
    r = torch.empty((S, N, 1), dtype=X.dtype, device=X.device)
    m = torch.empty((S, N, 1), dtype=X.dtype, device=X.device)
    log_jac = torch.empty((S,), dtype=X.dtype, device=X.device)
    for s in range(S):
        Ks, sn2[s], r[s], m[s], log_jac[s] = assemble(
            spec, hyps[s], X, y, s2, n_real)
        K[s] = Ks
        del Ks
    return K, sn2, r, m, log_jac


def _batched(hyp, X):
    hyp = to_device("stack_hyp", hyp, X.dtype, X.device)
    return hyp[None] if hyp.ndim == 1 else hyp, hyp.ndim == 1


def _each_lane(fn, hyp, X):
    """``fn`` of one vector, over one vector or a stack (S,).  Each vector
    of a stack is the span ``gpyreg.nlml.lane``; one vector alone is its
    caller's lane (:func:`value_and_grad` opens it)."""
    hyps, single = _batched(hyp, X)
    if single:
        return fn(hyps[0])
    outs = []
    for h in hyps:
        with span("gpyreg.nlml.lane"):
            outs.append(fn(h))
    return torch.stack(outs)


def gp_parts(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """(sn2_vec, m, L, mult, r, alpha, log_jacobian) with L = chol(G)
    lower, each with a leading sample axis when ``hyp`` is a stack."""
    hyps, single = _batched(hyp, X)
    K, sn2_vec, r, m, log_jac = _assemble_batch(spec, hyps, X, y, s2, n_real)
    L, mult = jittered_cholesky(K, sn2_vec)
    del K
    alpha = chol_solve(L, r)
    out = (sn2_vec, m, L, mult, r, alpha, log_jac)
    return tuple(t[0] for t in out) if single else out


def _finish(quad, logdet_half, mult, N, n_real):
    """0.5 quad + logdet_half + n/2 log(2 pi), less the padded rows'
    exact share of the log-determinant (0.5 log(mult) each)."""
    if n_real is None:
        n_eff = N
    else:
        logdet_half = logdet_half - 0.5 * (N - n_real) * torch.log(mult)
        n_eff = n_real
    return 0.5 * quad + logdet_half + 0.5 * n_eff * _LOG_2PI


def nlz(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """Negative log marginal likelihood, differentiable in ``hyp``.

    Each vector runs through ``quad_logdet``'s analytic VJP, a stack one
    lane at a time.  With padding, the padded rows' exact contributions
    (0.5*log(mult) per row to the log-determinant, 0.5*log(2pi) per row
    to the constant) are subtracted.
    """
    N = X.shape[0]

    def one(h):
        K, sn2_vec, r, _, log_jac = assemble(spec, h, X, y, s2, n_real)
        return _finish(*quad_logdet(K, sn2_vec, r), N, n_real) - log_jac

    return _each_lane(one, hyp, X)


def nlz_chain(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """NLML value on the sampler's memory-lean schedule: the same value
    and multiplier as :func:`nlz`, but K is factored in place and, when
    a factorization fails, rebuilt from ``hyp`` for the next multiplier
    instead of being kept beside the factor (``gpyreg_tpu/core/
    nlml.py:147-218``).  Value only; one lane at a time."""
    N = X.shape[0]

    def one(h):
        hyp_cov = spec.split_hyp(h)[0]
        K, sn2_vec, r, _, log_jac = assemble(spec, h, X, y, s2, n_real)
        mult = torch.ones((), dtype=X.dtype, device=X.device)
        K.diagonal().add_(sn2_vec)
        L, info = factor_ex(K)
        del K
        for _ in range(1, CHOL_MAX_TRIES):
            with span("gpyreg.sync.chain_retry"):
                if not bool(info != 0):
                    break
            with span("gpyreg.chol.retry"):
                mult = mult * 10.0
                del L
                K = _cov_masked(spec, hyp_cov, X, n_real)
                K.diagonal().add_(mult * sn2_vec)
                L, info = factor_ex(K)
                del K
        with span("gpyreg.sync.chain_failed"):
            failed = bool(info != 0)
        if failed:
            L.fill_(float("nan"))
        alpha = chol_solve(L, r)
        quad = torch.sum(r * alpha)
        half = torch.sum(torch.log(L.diagonal()))
        return _finish(quad, half, mult, N, n_real) - log_jac

    with torch.no_grad():
        return _each_lane(one, hyp, X)


def nlz_design(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """Single-attempt NLML for ranking a space-filling design: a lane
    whose G does not factor at the nominal noise, or whose value is NaN,
    is +inf and sorts last (``gpyreg_tpu/core/nlml.py:221-247``).  Value
    only; one lane at a time."""
    N = X.shape[0]

    def one(h):
        K, sn2_vec, r, _, log_jac = assemble(spec, h, X, y, s2, n_real)
        K.diagonal().add_(sn2_vec)
        L, info = factor_ex(K)
        del K
        alpha = chol_solve(L, r)
        n_eff = N if n_real is None else n_real
        val = (0.5 * torch.sum(r * alpha) + torch.sum(torch.log(L.diagonal()))
               + 0.5 * n_eff * _LOG_2PI - log_jac)
        bad = (info != 0) | torch.isnan(val)
        return torch.where(bad, torch.full_like(val, math.inf), val)

    with torch.no_grad():
        return _each_lane(one, hyp, X)


def value_and_grad(fn, hyp, X):
    """(value, gradient) of the scalar ``fn(h)`` at one vector, or at each
    vector of a stack (S, hyp_N), one lane at a time: each lane's
    backward runs before the next lane's forward, so one lane's (N, N)
    buffers are live at a time.  ``h`` is a float64 tensor on X's
    device; the gradient is float64."""
    hyp = to_device("grad_hyp", hyp, torch.float64, X.device)
    single = hyp.ndim == 1
    vals, grads = [], []
    for h in hyp[None] if single else hyp:
        with span("gpyreg.nlml.lane"), torch.enable_grad():
            h = h.detach().clone().requires_grad_(True)
            with span("gpyreg.nlml.forward"):
                v = fn(h)
            with span("gpyreg.nlml.backward"):
                (g,) = torch.autograd.grad(v, h)
        vals.append(v.detach())
        grads.append(g)
    if single:
        return vals[0], grads[0]
    return torch.stack(vals), torch.stack(grads)


def posterior_factors(spec: ModelSpec, hyp, X, y, s2, n_real=None):
    """Device part of Posterior construction: (alpha, L_G_lower, mult,
    sn2_min).  The host converts these to the reference's stored-factor
    convention (upper Cholesky of the scaled matrix, or the explicit
    negative inverse) from the ``sn2_min >= 1e-6`` flag (reference
    gaussian_process.py:2404-2448).  With padding, sn2_min is taken over
    the real rows only."""
    sn2_vec, _, L, mult, _, alpha, _ = gp_parts(spec, hyp, X, y, s2, n_real)
    mask = _mask(X.shape[0], n_real, X.device)
    if mask is not None:
        big = torch.finfo(X.dtype).max
        sn2_vec = torch.where(mask, sn2_vec, torch.full_like(sn2_vec, big))
    sn2_min = torch.amin(sn2_vec, dim=-1)
    return alpha, L, mult, sn2_min


def _hyp64(hyp, X):
    return torch.as_tensor(hyp, dtype=torch.float64).to(X.device)


def get_fns(spec: ModelSpec, has_s2: bool, has_prior: bool,
            padded: bool = False):
    """The function bundle of a model family, under the keys of
    ``gpyreg_tpu.core.nlml.get_fns``.

    Every function takes ``(hyp, X, y[, s2][, n_real][, pack])``, the
    optional arguments present iff the corresponding flag (``pack`` is
    a :class:`~.priors.PriorPack` on X's device; the posterior-factor
    calls omit it).  ``nlz`` / ``nlz_grad`` give the NLML without the
    prior; ``obj`` / ``obj_grad`` / ``obj_batch`` / ``obj_grad_batch``
    give nlZ - log_prior; ``*_grad`` return ``(value, gradient)``;
    ``*_batch`` take a stack (B, hyp_N) and loop over its lanes;
    ``obj_raw``, ``obj_design_raw``, ``log_post_raw``,
    ``log_post_chain_raw`` and ``log_prior_raw`` are the single-vector
    functions (``obj_raw`` and ``log_post_raw`` differentiable by
    autograd); ``post`` / ``post_batch`` give the posterior factors.
    """

    def _split(args):
        X, y = args[0], args[1]
        i = 2
        s2 = n_real = pack = None
        if has_s2:
            s2 = args[i]
            i += 1
        if padded:
            n_real = int(args[i])
            i += 1
        if has_prior and i < len(args):
            pack = args[i]
        return X, y, s2, n_real, pack

    def _obj(hyp, *args):
        X, y, s2, n_real, pack = _split(args)
        v = nlz(spec, hyp, X, y, s2, n_real)
        if pack is not None:
            v = v - log_prior(pack, _hyp64(hyp, X))
        return v

    def _nlz(hyp, *args):
        X, y, s2, n_real, _ = _split(args)
        return nlz(spec, hyp, X, y, s2, n_real)

    def _post(hyp, *args):
        X, y, s2, n_real, _ = _split(args)
        with torch.no_grad():
            return posterior_factors(spec, hyp, X, y, s2, n_real)

    def _obj_design(hyp, *args):
        X, y, s2, n_real, pack = _split(args)
        v = nlz_design(spec, hyp, X, y, s2, n_real)
        if pack is not None:
            with torch.no_grad():
                v = v - log_prior(pack, _hyp64(hyp, X))
        return v

    def _log_post_chain(hyp, *args):
        X, y, s2, n_real, pack = _split(args)
        v = nlz_chain(spec, hyp, X, y, s2, n_real)
        if pack is not None:
            with torch.no_grad():
                v = v - log_prior(pack, _hyp64(hyp, X))
        return -v

    def _log_prior(hyp, *args):
        X, _, _, _, pack = _split(args)
        if pack is None:
            return torch.zeros((), dtype=torch.float64, device=X.device)
        return log_prior(pack, _hyp64(hyp, X))

    def _no_grad(fn):
        def run(hyp, *args):
            with torch.no_grad():
                return fn(hyp, *args)
        return run

    def _grad(fn):
        def run(hyp, *args):
            return value_and_grad(lambda h: fn(h, *args), hyp, args[0])
        return run

    def _obj_batch(hyps, *args):
        X, y, s2, n_real, pack = _split(args)
        with torch.no_grad():
            v = nlz(spec, hyps, X, y, s2, n_real)
            if pack is not None:
                h = _hyp64(hyps, X)
                v = v - torch.stack([log_prior(pack, hi) for hi in h])
        return v

    return {
        "log_post_raw": lambda hyp, *args: -_obj(hyp, *args),
        "log_post_chain_raw": _log_post_chain,
        "log_prior_raw": _log_prior,
        "obj_raw": _obj,
        "obj_design_raw": _obj_design,
        "nlz": _no_grad(_nlz),
        "nlz_grad": _grad(_nlz),
        "obj": _no_grad(_obj),
        "obj_grad": _grad(_obj),
        "obj_batch": _obj_batch,
        "obj_grad_batch": _grad(_obj),
        "post": _post,
        "post_batch": _post,
    }
