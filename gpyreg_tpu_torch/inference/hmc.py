"""Hamiltonian Monte Carlo sampling of a density that lives on the
device, with the chain driven from the host.

Port of ``gpyreg_tpu/inference/hmc.py``: the leapfrog step ``_hmc_step``
(:55-125), ``_pack`` (:166-188) and ``sample`` (:281-414).  The MATLAB
oracle's ``'hmc'`` option (gplite_train.m:433-447): 10 leapfrog steps a
proposal, the slice widths as the position-scale preconditioner, and no
scaling of the sample counts by the number of hyperparameters.

Iteration (position x, whitened momentum p, preconditioner m):

    p0 ~ N(0, I) on the free dimensions, e = e0 * U[0.9, 1.1)
    n_leapfrog x [p += e/2 m g;  x += e m p;  p += e/2 m g]
    log a = (v' - |p'|^2 / 2) - (v - |p0|^2 / 2)

During burn-in the step size follows Robbins-Monro toward the 0.651
acceptance and the preconditioner the chain's Welford standard
deviation, as in :mod:`.mala`; both freeze after burn-in.

As in :mod:`.mala`, the position, the step size, the preconditioner and
the Welford moments stay on the host in float64 numpy, and each leapfrog
point makes one value-and-gradient call of ``log_f`` on the device of
``f_args``, value and gradient in one transfer; the stream's
:meth:`~.device_slice.TorchStream.hamiltonian` follows the JAX key tree
``key, k_mom, k_jit, k_acc = split(key, 4)``.

A leapfrog point outside ``[LB, UB]`` is evaluated as the JAX code
evaluates it (``_masked_value_and_grad``,
``gpyreg_tpu/inference/mala.py:61-72``): its value is -inf, and the
finite gradient of ``log_f`` there is kept, with only non-finite entries
zeroed, so a trajectory that leaves the box can turn back into it and be
accepted.  Each leapfrog point makes one call, inside the box or not
(:class:`_value_and_grad`); MALA's helper, which skips the call outside
the box, is right only for MALA, whose proposal outside the box is
rejected whatever its gradient.

Left out, with the JAX package's lines, for good, being TPU-only: the
segmented chain ``_hmc_init``, ``_hmc_seg``, ``_hmc_pack_blocks`` and
``_run_chain_segmented`` (:195-279) and ``sample``'s ``seg_iters``.
"""

import math

import numpy as np

from .device_slice import _as_stream
from .mala import (_Adaptation, _accept_p, _masked_value_and_grad, _result,
                   _start)

_TARGET_ACCEPT = 0.651  # optimal HMC acceptance (Beskos et al. 2013)


class _value_and_grad(_masked_value_and_grad):
    """``x -> (value, gradient)`` of ``log_f(x, *f_args)`` at every
    point, as the JAX code's ``_masked_value_and_grad`` computes it: out
    of bounds the value is -inf and the gradient the density's own, a NaN
    value -inf, and non-finite gradient entries 0."""

    def __call__(self, x):
        v, g = self._evaluate(x)
        if not np.all((x >= self.LB) & (x <= self.UB)):
            v = -math.inf
        return v, g


def _run_chain(vg, x0, stream, M_sqrt, log_eps, n_iters, burn, n_leap):
    """The whole chain.  Returns (initial value, positions (n_iters, D),
    values (n_iters,), accept flags (n_iters,), final log step size)."""
    D = x0.shape[0]
    ad = _Adaptation(M_sqrt, burn, _TARGET_ACCEPT)
    free = ad.free.astype(np.float64)
    x = x0.copy()
    v, g = vg(x)
    v0 = v
    if not math.isfinite(v0):
        return v0, None, None, None, log_eps
    xs = np.empty((n_iters, D))
    vs = np.empty((n_iters,))
    accepts = np.empty((n_iters,), dtype=bool)
    for it in range(n_iters):
        p0, jitter, u = stream.hamiltonian(D)
        # +/-10% step jitter: fixed (e, L) trajectories can resonate
        # with the target's length scales (Neal 2011 section 5.4.2.2).
        eps = math.exp(log_eps) * jitter
        p0 = p0 * free
        m_sqrt = ad.m_sqrt
        xq, vq, gq, p = x, v, g, p0
        for _ in range(n_leap):
            p = p + 0.5 * eps * m_sqrt * gq
            xq = xq + eps * m_sqrt * p
            vq, gq = vg(xq)
            p = p + 0.5 * eps * m_sqrt * gq

        log_ratio = (vq - 0.5 * np.sum(p * p)) - (v - 0.5 * np.sum(p0 * p0))
        if math.isnan(log_ratio):
            log_ratio = -math.inf
        accept = math.log(u) < log_ratio
        if accept:
            x, v, g = xq, vq, gq
        log_eps = ad.step(it, x, log_eps, _accept_p(log_ratio))
        xs[it], vs[it], accepts[it] = x, v, accept
    return v0, xs, vs, accepts, log_eps


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
    n_leapfrog: int = 10,
    f_args=(),
    log_prior=None,
    diagnostics: bool = True,
):
    """Draw ``n_samples`` (thinned) samples from ``log_f`` with HMC.

    Arguments as :func:`.mala.sample`.  ``n_leapfrog`` is gplite's
    ``steps`` (default 10, gplite_train.m:437); ``step_size`` the initial
    step size (gplite's ``stepadj``, default 0.01, :439; adapted during
    burn-in); ``widths`` the position-scale preconditioner (:442).

    Returns ``(result, final_position)``, the result as
    :func:`.mala.sample`'s.
    """
    x0, LBa, UBa, w = _start(x0, widths, LB, UB)
    if step_size is None:
        step_size = 0.01
    if burn is None:
        burn = round(n_samples / 3)
    n_iters = int(burn + n_samples * thin)
    vg = _value_and_grad(log_f, LBa, UBa, tuple(f_args))
    chain = _run_chain(vg, x0, _as_stream(key), w, float(np.log(step_size)),
                       n_iters, int(burn), int(n_leapfrog))
    return _result("HMCSampler", *chain, x0, n_samples, int(burn), thin,
                   tuple(f_args), log_prior, diagnostics)
