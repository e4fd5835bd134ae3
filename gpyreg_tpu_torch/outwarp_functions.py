"""Output-warping functions.

Port of ``gpyreg_tpu/outwarp_functions.py`` (the whole module).  A warp
``g`` maps observations so that the GP models ``g(y)``; the marginal
likelihood gains the Jacobian term ``-sum(log |g'(y)|)`` and user noise
scales by ``g'(y)^2`` (matlab/gplite/private/gplite_core.m:13-30, :115).
All three warps act only below a learned threshold ``y0`` and stretch the
lower tail by a learned power, for log-density targets with heavy
negative tails:

- ``negpow`` (outwarp_negpow.m:86-101):
    g(y) = y0 - (y0 - y)^k              for y < y0, identity above.
- ``negpowc1`` (outwarp_negpowc1.m, C1-continuous at y0):
    g(y) = y0 - ((1 + y0 - y)^k - 1)/k  for y < y0.
- ``negscaledpow`` (outwarp_negscaledpow.m, extra scale a):
    g(y) = y0 - (a*(y0 - y))^k          for y < y0.

The hyperparameters are (y0, log k), with log a before log k for
``negscaledpow``, at the end of the GP's vector (cov | noise | mean |
outwarp, gplite_core.m:16).  :func:`warp_value_and_dt` and
:func:`warp_inverse` work on tensors of any device and dtype, and autograd
gives the gradient in the warp hyperparameters.
"""

import numpy as np
import torch

from .covariance_functions import _validate_hyp

OUTWARP_KINDS = ("negpow", "negpowc1", "negscaledpow")


def outwarp_hyp_count(kind: str) -> int:
    return 3 if kind == "negscaledpow" else 2


def _scale_power(kind, hyp_ow):
    if kind == "negscaledpow":
        return torch.exp(hyp_ow[1]), torch.exp(hyp_ow[2])
    return 1.0, torch.exp(hyp_ow[1])


def warp_value_and_dt(kind: str, hyp_ow, y):
    """(g(y), g'(y)) for a tensor ``y`` of any shape.

    The branch below the threshold takes a masked ``delta`` (1 where
    y >= y0), so that its powers, and autograd through them, stay finite
    on the identity branch."""
    y0 = hyp_ow[0]
    a, k = _scale_power(kind, hyp_ow)
    below = y < y0
    delta = torch.where(below, y0 - y, torch.ones_like(y))

    if kind == "negpow":
        g_below = y0 - delta**k
        dt_below = k * delta ** (k - 1.0)
    elif kind == "negpowc1":
        base = 1.0 + delta
        g_below = y0 - (base**k - 1.0) / k
        dt_below = base ** (k - 1.0)
    elif kind == "negscaledpow":
        g_below = y0 - (a * delta) ** k
        dt_below = a * k * (a * delta) ** (k - 1.0)
    else:
        raise ValueError(f"Unknown output warping kind: {kind}")

    g = torch.where(below, g_below, y)
    dt = torch.where(below, dt_below, torch.ones_like(y))
    return g, dt


def warp_inverse(kind: str, hyp_ow, z):
    """g^{-1}(z) (outwarp_*.m invflag branches)."""
    y0 = hyp_ow[0]
    a, k = _scale_power(kind, hyp_ow)
    below = z < y0
    delta = torch.where(below, y0 - z, torch.ones_like(z))

    if kind == "negpow":
        inv_below = y0 - delta ** (1.0 / k)
    elif kind == "negpowc1":
        inv_below = y0 + 1.0 - (1.0 + k * delta) ** (1.0 / k)
    elif kind == "negscaledpow":
        inv_below = y0 - (delta ** (1.0 / k)) / a
    else:
        raise ValueError(f"Unknown output warping kind: {kind}")

    return torch.where(below, inv_below, z)


class _AbstractOutputWarping:
    """The covariance/mean/noise protocol of the reference
    (``hyperparameter_count``, ``hyperparameter_info``,
    ``get_bounds_info``, ``compute``) for an output warp."""

    _kind: str = None

    def hyperparameter_count(self):
        return outwarp_hyp_count(self._kind)

    def hyperparameter_info(self):
        if self._kind == "negscaledpow":
            return [
                ("outwarp_threshold", 1),
                ("outwarp_log_scale", 1),
                ("outwarp_log_power", 1),
            ]
        return [("outwarp_threshold", 1), ("outwarp_log_power", 1)]

    def get_bounds_info(self, X, y):
        """Data-driven bounds (outwarp_negpow.m:31-64): the threshold
        spans the observed y range; the log-powers are plausibly in
        [-3, 3]."""
        n = self.hyperparameter_count()
        LB = np.full((n,), -np.inf)
        UB = np.full((n,), np.inf)
        PLB = np.full((n,), -np.inf)
        PUB = np.full((n,), np.inf)
        x0 = np.full((n,), np.nan)

        LB[0] = PLB[0] = np.min(y)
        UB[0] = PUB[0] = np.max(y)

        PLB[1:] = -3.0
        PUB[1:] = 3.0
        x0[1:] = 0.0

        i_nan = np.isnan(x0)
        x0[i_nan] = 0.5 * (PLB[i_nan] + PUB[i_nan])
        return {"LB": LB, "UB": UB, "PLB": PLB, "PUB": PUB, "x0": x0}

    def compute(self, hyp, y, inverse: bool = False, compute_grad=False):
        """g(y), or g^{-1}(y) with ``inverse``, in float64 numpy; with
        ``compute_grad`` also g'(y)."""
        hyp = np.asarray(hyp, dtype=np.float64)
        _validate_hyp(hyp, self.hyperparameter_count(), kind="output warping")
        h = torch.as_tensor(hyp.ravel())
        yt = torch.as_tensor(np.asarray(y, dtype=np.float64))
        if inverse:
            if compute_grad:
                raise ValueError(
                    "When calling for the inverse output warping "
                    "function, only one function output is expected."
                )
            return warp_inverse(self._kind, h, yt).numpy()
        g, dt = warp_value_and_dt(self._kind, h, yt)
        if compute_grad:
            return g.numpy(), dt.numpy()
        return g.numpy()


class NegativePower(_AbstractOutputWarping):
    """g(y) = y0 - (y0 - y)^k below y0 (outwarp_negpow.m)."""

    _kind = "negpow"


class NegativePowerC1(_AbstractOutputWarping):
    """C1-continuous variant (outwarp_negpowc1.m)."""

    _kind = "negpowc1"


class NegativeScaledPower(_AbstractOutputWarping):
    """Scaled variant g(y) = y0 - (a (y0 - y))^k (outwarp_negscaledpow.m)."""

    _kind = "negscaledpow"
