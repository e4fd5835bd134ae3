"""The smoothbox distribution functions, host-side numpy/scipy.

A copy of ``smoothbox_cdf`` and ``smoothbox_student_t_cdf``
(``gpyreg_tpu/f_min_fill.py:207-226``, :250-268, with ``_student_t_peak``
:24-26), which the priors' truncation constants need
(``GP.__recompute_normalization_constants``).

Left out until the fit slice: the rest of the module, that is
``f_min_fill`` itself with its design warping (:29-204, :291-end) and the
quantile functions ``smoothbox_ppf`` / ``smoothbox_student_t_ppf``
(:229-247, :271-288).
"""

import math

import numpy as np
import scipy as sp

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _student_t_peak(df, sigma):
    """Density at the center of a Student-t(df, scale=sigma)."""
    return float(sp.stats.t.pdf(0.0, df, scale=sigma))


def smoothbox_cdf(x, sigma, a, b):
    """CDF of the smoothbox distribution: a flat plateau on [a, b] glued
    to two Gaussian half-densities of scale ``sigma`` (reference
    f_min_fill.py:249-274).  Vectorized in ``x``."""
    xv = np.asarray(x, dtype=np.float64)
    # Unnormalized mass: 1 (the two flanks) + plateau area.
    plateau = (b - a) / (sigma * _SQRT_2PI)
    Z = 1.0 + plateau
    cdf = (
        np.select(
            [xv < a, xv <= b],
            [
                sp.stats.norm.cdf(xv, loc=a, scale=sigma),
                0.5 + (xv - a) / (sigma * _SQRT_2PI),
            ],
            plateau + sp.stats.norm.cdf(xv, loc=b, scale=sigma),
        )
        / Z
    )
    return cdf if np.ndim(x) else float(cdf)


def smoothbox_student_t_cdf(x, df, sigma, a, b):
    """CDF of the smoothbox Student-t distribution (t flanks of scale
    ``sigma`` and ``df`` degrees of freedom); vectorized in ``x``."""
    xv = np.asarray(x, dtype=np.float64)
    peak = _student_t_peak(df, sigma)
    plateau = (b - a) * peak
    Z = 1.0 + plateau
    cdf = (
        np.select(
            [xv < a, xv <= b],
            [
                sp.stats.t.cdf(xv, df, loc=a, scale=sigma),
                0.5 + (xv - a) * peak,
            ],
            plateau + sp.stats.t.cdf(xv, df, loc=b, scale=sigma),
        )
        / Z
    )
    return cdf if np.ndim(x) else float(cdf)
