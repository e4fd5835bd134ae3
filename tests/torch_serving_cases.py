"""Shared inputs of the serving tests of the port (``test_torch_rank1.py``,
``test_torch_serving_full.py``, ``test_torch_quad.py``,
``test_torch_fmin_plot.py``): one GP of each package on the same numpy
data and hyperparameters, in float64, the port's on the CPU."""

import numpy as np

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt

RTOL = 1e-8


def _cov(pkg, cov):
    if cov == "se":
        return pkg.covariance_functions.SquaredExponential()
    if cov == "m5":
        return pkg.covariance_functions.Matern(5)
    if cov == "se_iso":
        return pkg.isotropic_covariance_functions.SquaredExponentialIsotropic()
    raise ValueError(cov)


def _mean(pkg, mean):
    return {
        "zero": pkg.mean_functions.ZeroMean,
        "const": pkg.mean_functions.ConstantMean,
        "negquad": pkg.mean_functions.NegativeQuadratic,
    }[mean]()


def make(pkg, D, cov="se", mean="const", user_noise=False, dtype=None):
    kw = {"dtype": dtype} if pkg is gj else {"dtype": dtype, "device": "cpu"}
    return pkg.GP(
        D, _cov(pkg, cov), _mean(pkg, mean),
        pkg.noise_functions.GaussianNoise(constant_add=True,
                                          user_provided_add=user_noise),
        **kw,
    )


def data(rng, N, D):
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))
    return X, y


def pair(log_sn, N=50, D=2, cov="se", mean="const", seed=0):
    """(JAX GP, port GP, rng): both conditioned on the same N rows and the
    same hyperparameter samples, one a noise log-scale of ``log_sn``."""
    rng = np.random.default_rng(seed)
    X, y = data(rng, N, D)
    g, t = make(gj, D, cov, mean), make(gt, D, cov, mean)
    cov_N = g._hyp_counts()[0]
    hyp = 0.1 * rng.normal(size=(len(log_sn), g._hyp_N()))
    hyp[:, cov_N] = log_sn
    for m in (g, t):
        m.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=True)
    return g, t, rng


def rel(a, b):
    """max |a - b| over max |b| (at least 1e-300)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def factors(p):
    """A port Posterior's factors as numpy arrays."""
    return {f: getattr(p, f).numpy() for f in ("L", "alpha", "sW")}
