"""Space-filling hyperparameter initialization, host-side numpy/scipy.

Port of ``gpyreg_tpu/f_min_fill.py`` (API parity with reference
f_min_fill.py:11-180): ``_dim_warper``, ``build_design``, ``f_min_fill``,
``uuinv`` and the smoothbox distribution functions (CDFs, which the
priors' truncation constants also need, and quantile functions).  As in
the JAX package, the objective is evaluated at all design points through a
batched evaluator (``f_batch``, the GP's ``_objective_batch``), and the
prior warping is vectorized over the design points.

``build_design`` and ``f_min_fill`` take an explicit ``rng`` (a
``numpy.random.Generator`` or ``RandomState``) for the column permutation
of the Sobol points and for the uniform design.  ``rng=None`` draws from
numpy's global stream exactly as the JAX package does (:114, :116), so
``np.random.seed(k)`` gives both packages the same design.

Nothing of the module is left out.
"""

import math
import warnings

import numpy as np
import scipy as sp

_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _student_t_peak(df, sigma):
    """Density at the center of a Student-t(df, scale=sigma)."""
    return float(sp.stats.t.pdf(0.0, df, scale=sigma))


def _dim_warper(i, LB, UB, PLB, PUB, hprior, n_vars):
    """Build the quantile->value warp for design dimension ``i``.

    Family selection mirrors reference f_min_fill.py:104-168: uniform
    priors map through a mixture-of-uniforms inverse CDF concentrating
    half the mass in the plausible box; smoothbox / Gaussian / Student-t
    priors map through their (bound-truncated) inverse CDFs, with tails
    fattened by capping df at 3.
    """
    mu = hprior["mu"][i]
    sigma = hprior["sigma"][i]
    a, b = hprior["a"][i], hprior["b"][i]
    lb, ub = LB[i], UB[i]

    if not (np.isfinite(mu) or np.isfinite(sigma)):
        # No location/scale info: uniform over the box.
        if np.isfinite(lb) and np.isfinite(ub):
            if lb == ub:
                return lambda q: np.full(np.shape(q), lb)
            w_in = 0.5 ** (1.0 / n_vars)
            box = (lb, PLB[i], PUB[i], ub)
            return lambda q: uuinv(q, box, w_in)
        plb, pub = PLB[i], PUB[i]
        return lambda q: plb + q * (pub - plb)

    df = hprior["df"][i]
    df = 3.0 if not np.isfinite(df) else min(df, 3.0)

    if np.isfinite(a) and np.isfinite(b):
        if df == 0:
            lo = smoothbox_cdf(lb, sigma, a, b)
            hi = smoothbox_cdf(ub, sigma, a, b)
            return lambda q: smoothbox_ppf(
                lo + (hi - lo) * q, sigma, a, b
            )
        lo = smoothbox_student_t_cdf(lb, df, sigma, a, b)
        hi = smoothbox_student_t_cdf(ub, df, sigma, a, b)
        return lambda q: smoothbox_student_t_ppf(
            lo + (hi - lo) * q, df, sigma, a, b
        )

    if df == 0:
        lo = sp.stats.norm.cdf((lb - mu) / sigma)
        hi = sp.stats.norm.cdf((ub - mu) / sigma)
        return lambda q: mu + sigma * sp.stats.norm.ppf(lo + (hi - lo) * q)
    lo = sp.stats.t.cdf((lb - mu) / sigma, df)
    hi = sp.stats.t.cdf((ub - mu) / sigma, df)
    return lambda q: mu + sigma * sp.stats.t.ppf(lo + (hi - lo) * q, df)


def build_design(
    x0,
    LB: np.ndarray,
    UB: np.ndarray,
    PLB: np.ndarray,
    PUB: np.ndarray,
    hprior: dict,
    N: int,
    design: str = None,
    rng=None,
):
    """The design-construction half of :func:`f_min_fill`: clipped x0
    rows followed by the prior-warped Sobol/uniform candidates, with NO
    objective evaluation.  Used by the fused design + optimize path
    (inference.map_optimize.design_optimize), which ranks the design on
    the device.  ``rng`` None means numpy's global stream."""
    if design is None:
        design = "sobol"
    if rng is None:
        rng = np.random

    N0 = x0.shape[0]
    n_vars = max(
        x0.shape[1], np.size(LB), np.size(UB), np.size(PLB), np.size(PUB)
    )

    # Clip provided points into bounds.
    x0 = np.minimum(np.maximum(x0, LB), UB)

    X = x0
    if N > N0:
        if design == "sobol":
            sampler = sp.stats.qmc.Sobol(d=n_vars, scramble=False)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                S = sampler.random(n=N - N0 + 1)[1:, :]  # drop the zero point
            # Random column permutation decorrelates the assignment of
            # Sobol dimensions to hyperparameters (reference :92).
            rng.shuffle(S.T)
        elif design == "rand":
            S = rng.uniform(size=(N - N0, n_vars))
        else:
            raise ValueError(
                "Unknown design: got "
                + design
                + ' and expected either "sobol" or "rand"'
            )

        # Warp every dimension's quantile column in one vectorized call.
        cols = [
            _dim_warper(i, LB, UB, PLB, PUB, hprior, n_vars)(S[:, i])
            for i in range(n_vars)
        ]
        X = np.concatenate([x0, np.stack(cols, axis=1)])
    return X


def f_min_fill(
    f,
    x0,
    LB: np.ndarray,
    UB: np.ndarray,
    PLB: np.ndarray,
    PUB: np.ndarray,
    hprior: dict,
    N: int,
    design: str = None,
    f_batch=None,
    rng=None,
):
    """Create a space-filling design, evaluate ``f`` everywhere, sort.

    Parameters mirror reference f_min_fill.py:11-57.  ``f_batch``, if
    given, maps an (N, hyp_N) array to an (N,) array of objective values
    in one call (the device path); otherwise ``f`` is called
    point-wise like the reference.

    Returns (X sorted by objective ascending, sorted objective values).
    """
    X = build_design(x0, LB, UB, PLB, PUB, hprior, N, design, rng)
    # When x0 carries more rows than N, the reference evaluates (and
    # returns) only the first N (f_min_fill.py:174-180); keep the
    # batched path on the same contract.
    X = X[:N]

    if f_batch is not None:
        y = np.asarray(f_batch(X), dtype=np.float64).reshape(-1)
        # Failed evaluations (NaN from an unfactorizable kernel matrix)
        # sort last instead of aborting the whole design.
        y = np.where(np.isfinite(y), y, np.inf)
    else:
        y = np.array([f(X[i, :]) for i in range(N)], dtype=np.float64)

    order = np.argsort(y)
    return X[order, :], y[order]


def uuinv(p, B, w):
    """Inverse CDF of a mixture of uniforms: mass ``w`` uniform on the
    inner interval [B[1], B[2]], mass ``1-w`` split over the outer
    intervals [B[0], B[1]] and [B[2], B[3]] proportionally to their
    lengths (reference f_min_fill.py:183-246, including the degenerate
    delta mixture when both outer intervals have zero length)."""
    b0, b1, b2, b3 = (float(v) for v in B)
    assert b0 <= b1 <= b2 <= b3
    assert 0 <= w <= 1
    p = np.asarray(p, dtype=np.float64)

    if w == 1:
        return b1 + p * (b2 - b1)

    outer = (b1 - b0) + (b3 - b2)
    if outer == 0:
        # Point outer intervals: two deltas plus the inner uniform.
        half = 0.5 * (1 - w)
        inner = (
            (p - half) * (b2 - b1) / w + b1 if w != 0 else np.full_like(p, b1)
        )
        x = np.select(
            [p <= half, p <= half + w], [np.full_like(p, b0), inner], b3
        )
        return np.where((p < 0) | (p > 1), np.nan, x)

    # Mass of the lower outer segment; density on outer = (1-w)/outer.
    m_lo = (1 - w) * (b1 - b0) / outer
    lower = b0 + p * outer / (1 - w)
    inner = (p - m_lo) * (b2 - b1) / w + b1 if w != 0 else lower
    upper = b2 + (p - m_lo - w) * outer / (1 - w)
    x = np.select([p <= m_lo, p <= m_lo + w], [lower, inner], upper)
    return np.where((p < 0) | (p > 1), np.nan, x)


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


def smoothbox_ppf(q, sigma, a, b):
    """Quantile function of the smoothbox distribution; vectorized."""
    qv = np.asarray(q, dtype=np.float64)
    plateau = (b - a) / (sigma * _SQRT_2PI)
    Z = 1.0 + plateau
    with np.errstate(invalid="ignore"):
        x = np.select(
            [qv * Z < 0.5, qv * Z <= 0.5 + plateau],
            [
                sp.stats.norm.ppf(qv * Z, loc=a, scale=sigma),
                a + (qv * Z - 0.5) * (sigma * _SQRT_2PI),
            ],
            # 1 - Z*(1-q) == q*Z - plateau exactly in real arithmetic,
            # but stays exact at q=1 (-> +inf) and keeps precision in
            # the upper tail (reference f_min_fill.py:335-337 relies on
            # C*q - (C-1) cancelling to 1.0 there).
            sp.stats.norm.ppf(1.0 - Z * (1.0 - qv), loc=b, scale=sigma),
        )
    return x if np.ndim(q) else float(x)


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


def smoothbox_student_t_ppf(q, df, sigma, a, b):
    """Quantile function of the smoothbox Student-t distribution;
    vectorized."""
    qv = np.asarray(q, dtype=np.float64)
    peak = _student_t_peak(df, sigma)
    plateau = (b - a) * peak
    Z = 1.0 + plateau
    with np.errstate(invalid="ignore"):
        x = np.select(
            [qv * Z < 0.5, qv * Z <= 0.5 + plateau],
            [
                sp.stats.t.ppf(qv * Z, df, loc=a, scale=sigma),
                a + (qv * Z - 0.5) / peak,
            ],
            # Upper-tail form exact at q=1 (see smoothbox_ppf).
            sp.stats.t.ppf(1.0 - Z * (1.0 - qv), df, loc=b, scale=sigma),
        )
    return x if np.ndim(q) else float(x)
