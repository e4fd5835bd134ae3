"""Metropolis-adjusted Langevin (MALA) sampling of a density that lives on
the device, with the chain driven from the host.

Port of ``gpyreg_tpu/inference/mala.py``: ``_masked_value_and_grad``
(:61-73), the truncated-drift step ``_mala_step`` (:76-172), ``_pack``
(:175-199) and ``sample`` (:339-463).  The MATLAB oracle's ``'mala'``
option (gplite_train.m:409-431): the preconditioner defaults to the
slice widths, and ``GP.fit`` scales the sample, burn-in and thinning
counts by the number of hyperparameters
(``inference/sampling.run_sampling``).

Transition (position x, step size e, preconditioner M = diag(m^2)):

    mu_fwd = x + drift(x),  drift = (e^2/2) M grad log pi(x), its length
             in preconditioner units capped at 4 e (truncated MALA)
    x'     = mu_fwd + e m xi,  xi ~ N(0, I)
    log a  = log pi(x') - log pi(x) + log q(x | x') - log q(x' | x)

During burn-in the step size follows Robbins-Monro on log e toward the
0.574 acceptance with rate (it + 1)^-0.55, and after ``_ADAPT_START``
steps the preconditioner of the free dimensions is the chain's Welford
standard deviation, floored at 1e-3 of the starting widths; both freeze
after burn-in.

The JAX chain is one XLA program (a ``scan`` over steps).  Here the
position, the step size, the preconditioner and the Welford moments stay
on the host in float64 numpy, and each step makes one value-and-gradient
call of ``log_f`` on the device of ``f_args`` (the GP's), whose value
and gradient come back in one transfer.  A proposal outside ``[LB, UB]``
is (-inf, 0) without a call of ``log_f``: the JAX chain evaluates it and
masks the value, which gives the same chain, since such a proposal is
rejected whatever its gradient.

The random stream is that of ``device_slice``: per step
:meth:`~.device_slice.TorchStream.langevin` gives the proposal's normal
and the acceptance uniform, as the JAX chain splits ``key, k_prop, k_acc
= split(key, 3)``; a test replays the JAX key tree through it.

Left out, with the JAX package's lines, for good, being TPU-only: the
segmented chain ``_mala_init``, ``_mala_seg``, ``_mala_pack`` and
``_run_chain_segmented`` (:247-337) and ``sample``'s ``seg_iters``,
which bound the device time of one dispatch under the TPU runtime's
watchdog; the host-driven chain has no dispatch to bound.
"""

import logging
import math

import numpy as np
import torch

from .device_slice import _as_stream, _expand, diagnose

_logger = logging.getLogger("MALASampler")

_TARGET_ACCEPT = 0.574  # optimal MALA acceptance (Roberts & Rosenthal)
_MAX_DRIFT = 4.0  # truncated-MALA drift cap, preconditioner units
_ADAPT_START = 16  # Welford warm-up before rescaling the diagonal
_TINY = float(np.finfo(np.float64).tiny)


def _device_of(f_args):
    """Where ``log_f`` runs: the device of the first tensor among its
    arguments (the GP's data), else the CPU."""
    for a in f_args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


class _masked_value_and_grad:
    """``x (float64 numpy) -> (value, gradient (D,))`` of ``log_f(x,
    *f_args)``: out of bounds -inf with a zero gradient and no call of
    ``log_f``, a NaN value -inf, and non-finite gradient entries 0.  The
    value and the gradient come back from the device in one transfer."""

    def __init__(self, log_f, LB, UB, f_args=()):
        self.log_f, self.LB, self.UB, self.f_args = log_f, LB, UB, f_args
        self.device = _device_of(f_args)

    def __call__(self, x):
        if not np.all((x >= self.LB) & (x <= self.UB)):
            return -math.inf, np.zeros_like(x)
        return self._evaluate(x)

    def _evaluate(self, x):
        """The call of ``log_f`` at ``x``, with the NaN value and the
        non-finite gradient entries masked."""
        h = torch.tensor(x, dtype=torch.float64, device=self.device,
                         requires_grad=True)
        with torch.enable_grad():
            v = torch.as_tensor(self.log_f(h, *self.f_args), device=self.device)
            if v.requires_grad:
                (g,) = torch.autograd.grad(v, h)
            else:  # a density that does not depend on x
                g = torch.zeros_like(h)
        packed = torch.cat(
            [v.detach().reshape(1).to(torch.float64), g.to(torch.float64)]
        ).cpu().numpy()
        v = float(packed[0])
        g = packed[1:]
        if math.isnan(v):
            v = -math.inf
        return v, np.where(np.isfinite(g), g, 0.0)


def _log_q(x_to, mu, m_inv_sqrt):
    """-|(x_to - mu) / m|^2 / 2: the log proposal density up to its
    normalization and the 1/e^2 the caller applies (both cancel in the
    Metropolis-Hastings ratio)."""
    z = (x_to - mu) * m_inv_sqrt
    return -0.5 * np.sum(z * z)


class _Adaptation:
    """The burn-in adaptation shared with HMC: Robbins-Monro on log e
    toward ``target`` and the Welford preconditioner of the free
    dimensions, frozen after ``burn`` steps (``_mala_step`` :137-157,
    ``hmc._hmc_step`` :101-115)."""

    def __init__(self, M_sqrt, burn, target):
        self.M_sqrt, self.burn, self.target = M_sqrt, burn, target
        self.free = M_sqrt > 0.0  # fixed dims (LB == UB) carry zero scale
        self.m_sqrt = M_sqrt.copy()
        self.w_mean = np.zeros_like(M_sqrt)
        self.w_m2 = np.zeros_like(M_sqrt)

    def step(self, it, x, log_eps, accept_p):
        """The step size after step ``it`` (0-based) at position ``x``;
        updates the preconditioner ``m_sqrt``."""
        if not it < self.burn:
            return log_eps
        cnt = it + 1.0
        log_eps = log_eps + cnt ** -0.55 * (accept_p - self.target)
        delta = x - self.w_mean
        self.w_mean = self.w_mean + delta / cnt
        self.w_m2 = self.w_m2 + delta * (x - self.w_mean)
        if it >= _ADAPT_START:
            var = self.w_m2 / max(cnt - 1.0, 1.0)
            m_est = np.sqrt(np.maximum(var, 1e-6 * self.M_sqrt * self.M_sqrt))
            self.m_sqrt = np.where(self.free, m_est, self.m_sqrt)
        return log_eps


def _accept_p(log_ratio):
    return min(1.0, math.exp(min(log_ratio, 0.0)))


def _run_chain(vg, x0, stream, M_sqrt, log_eps, n_iters, burn):
    """The whole chain.  Returns (initial value, positions (n_iters, D),
    values (n_iters,), accept flags (n_iters,), final log step size)."""
    D = x0.shape[0]
    ad = _Adaptation(M_sqrt, burn, _TARGET_ACCEPT)
    x = x0.copy()
    v, g = vg(x)
    v0 = v
    if not math.isfinite(v0):
        return v0, None, None, None, log_eps
    xs = np.empty((n_iters, D))
    vs = np.empty((n_iters,))
    accepts = np.empty((n_iters,), dtype=bool)

    def drift(grad, e2, M, m_inv_sqrt, cap):
        d = 0.5 * e2 * M * grad
        dnorm = math.sqrt(np.sum((d * m_inv_sqrt) ** 2))
        return d * min(1.0, cap / max(dnorm, 1e-300))

    for it in range(n_iters):
        xi, u = stream.langevin(D)
        eps = math.exp(log_eps)
        e2 = eps * eps
        m_sqrt = ad.m_sqrt
        M = m_sqrt * m_sqrt
        m_inv_sqrt = np.where(ad.free, 1.0 / np.where(ad.free, m_sqrt, 1.0), 0.0)
        cap = _MAX_DRIFT * eps

        mu_fwd = x + drift(g, e2, M, m_inv_sqrt, cap)
        x_new = mu_fwd + eps * m_sqrt * xi
        v_new, g_new = vg(x_new)
        mu_bwd = x_new + drift(g_new, e2, M, m_inv_sqrt, cap)

        log_ratio = v_new - v + (
            _log_q(x, mu_bwd, m_inv_sqrt) - _log_q(x_new, mu_fwd, m_inv_sqrt)
        ) / e2
        if math.isnan(log_ratio):
            log_ratio = -math.inf
        accept = math.log(u) < log_ratio
        if accept:
            x, v, g = x_new, v_new, g_new
        log_eps = ad.step(it, x, log_eps, _accept_p(log_ratio))
        xs[it], vs[it], accepts[it] = x, v, accept
    return v0, xs, vs, accepts, log_eps


def _start(x0, widths, LB, UB):
    """(x0, LB, UB, preconditioner) of a gradient chain, as float64 (D,)
    arrays (``sample`` :375-394): the widths default to half the bound
    span, or 1 where it is infinite; fixed dimensions get zero scale."""
    x0 = np.asarray(x0, dtype=np.float64).ravel()
    D = x0.shape[0]
    LBa = _expand(LB, -np.inf, D)
    UBa = _expand(UB, np.inf, D)
    if np.any(x0 < LBa) or np.any(x0 > UBa):
        raise ValueError(
            "The initial starting point X0 is outside the bounds."
        )
    w = _expand(widths, np.nan, D)
    fin = np.isfinite(LBa) & np.isfinite(UBa)
    w = np.where(np.isnan(w), np.where(fin, (UBa - LBa) / 2.0, 1.0), w)
    w = np.maximum(w, _TINY)
    # Fixed dimensions (LB == UB) get zero proposal scale: pinned.
    return x0, LBa, UBa, np.where(LBa == UBa, 0.0, w)


def _result(name, v0, xs, vs, accepts, log_eps, x0, n_samples, burn, thin,
            f_args, log_prior, diagnostics):
    """``sample``'s result from the chain (:424-463): the post-burn steps
    thinned, the priors split out of the values, the diagnostics.
    Returns ``(result, final position)``."""
    if not math.isfinite(v0):
        raise ValueError(
            "The initial starting point X0 needs to evaluate to a real "
            "number (not Inf or NaN)."
        )
    kept_x, kept_v = xs[burn:], vs[burn:]
    accept_rate = float(np.mean(accepts[burn:])) if len(kept_v) else math.nan
    samples = kept_x[thin - 1 :: thin][:n_samples]
    f_vals = kept_v[thin - 1 :: thin][:n_samples]
    if log_prior is not None:
        log_priors = np.array([
            float(log_prior(torch.tensor(s), *f_args)) for s in samples
        ])
        f_vals = f_vals - log_priors
    else:
        log_priors = np.zeros_like(f_vals)

    logging.getLogger(name).info(
        "\nSampling terminated: %d samples, burn-in %d, "
        "acceptance rate %.2f, final step size %.3g",
        n_samples,
        burn,
        accept_rate,
        math.exp(log_eps),
    )
    if diagnostics:
        exit_flag, R, eff_N = diagnose(samples)
    else:
        exit_flag, R, eff_N = 0, None, None
    result = {
        "samples": samples,
        "f_vals": f_vals.reshape(-1, 1),
        "log_priors": log_priors,
        "exit_flag": exit_flag,
        "R": R,
        "eff_N": eff_N,
        "accept_rate": accept_rate,
    }
    return result, samples[-1] if len(samples) else x0


def sample(
    log_f,
    x0,
    key,
    n_samples: int,
    widths=None,
    LB=None,
    UB=None,
    burn: int = None,
    thin: int = 1,
    step_size: float = None,
    f_args=(),
    log_prior=None,
    diagnostics: bool = True,
):
    """Draw ``n_samples`` (thinned) samples from ``log_f`` with MALA.

    ``log_f`` is called as ``log_f(x, *f_args)`` with ``x`` a float64
    tensor (D,) on the device of the first tensor among ``f_args`` (the
    CPU if there is none) that requires grad, and returns a scalar
    tensor; its gradient comes from autograd.  ``key`` is a stream
    (:func:`~.device_slice.make_stream`) or an integer seed.  ``widths``
    sets the diagonal preconditioner (gplite_train.m:417-422 uses the
    slice widths); ``step_size`` the initial global step size (default
    2.4 / sqrt(D), adapted during burn-in); ``burn`` defaults to
    round(n_samples / 3).  ``log_prior`` (optional, ``(x, *f_args) ->
    scalar``, already included in ``log_f``) is reported per sample in
    ``log_priors`` and excluded from ``f_vals``.

    Returns ``(result, final_position)``: the result has ``samples``,
    ``f_vals`` (n, 1), ``log_priors``, ``exit_flag``, ``R``, ``eff_N``
    (``device_slice.diagnose``) and ``accept_rate`` (after burn-in).
    """
    x0, LBa, UBa, w = _start(x0, widths, LB, UB)
    D = x0.shape[0]
    if step_size is None:
        step_size = 2.4 / np.sqrt(D)
    if burn is None:
        burn = round(n_samples / 3)
    n_iters = int(burn + n_samples * thin)
    vg = _masked_value_and_grad(log_f, LBa, UBa, tuple(f_args))
    chain = _run_chain(vg, x0, _as_stream(key), w, float(np.log(step_size)),
                       n_iters, int(burn))
    return _result("MALASampler", *chain, x0, n_samples, int(burn), thin,
                   tuple(f_args), log_prior, diagnostics)
