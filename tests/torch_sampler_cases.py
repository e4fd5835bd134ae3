"""Shared inputs and checks of the tests that hold the port's MALA, HMC
and ensemble slice samplers (``gpyreg_tpu_torch.inference.mala``,
``hmc``, ``ensemble_slice``) to the JAX package's on the CPU in float64:
the two packages' GP log posteriors at N = 48, D = 2 with a hyperprior,
a bounded 3-D Gaussian with one fixed dimension, and the comparison of
two results."""

import jax.numpy as jnp
import numpy as np
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt

TOL = 1e-8
SEED = 11

# The 3-D Gaussian; its second dimension is fixed by the bounds.
MU = np.array([0.3, -0.5, 1.0])
SD = np.array([0.5, 1.0, 2.0])
_TMU, _TSD = torch.tensor(MU), torch.tensor(SD)
X0 = np.array([0.2, 0.2, 0.2])
LB3 = np.array([-4.0, 0.2, -4.0])
UB3 = np.array([5.0, 0.2, 5.0])


def j_gauss(x):
    return -0.5 * jnp.sum(((x - MU) / SD) ** 2)


def t_gauss(x):
    return -0.5 * torch.sum(((x - _TMU) / _TSD) ** 2)


def j_prior(x):
    return -0.1 * jnp.sum(jnp.abs(x))


def t_prior(x):
    return -0.1 * torch.sum(torch.abs(x))


def gauss(side, prior=False):
    """(log_f, log_prior) of the Gaussian, the prior also in log_f."""
    f, p = (j_gauss, j_prior) if side == "jax" else (t_gauss, t_prior)
    if not prior:
        return f, None
    return (lambda x: f(x) + p(x)), p


# The GP of tests/test_torch_sampling.py's pattern, with a hyperprior.
N, D = 48, 2
GP_X0 = np.array([0.2, -0.1, 0.1, np.log(0.3), 0.0])
GP_LB = GP_X0 - 3.0
GP_UB = GP_X0 + 3.0
GP_WIDTHS = np.array([0.3, 0.3, 0.3, 0.2, 0.3])


def _data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.3 * rng.normal(size=(N, 1))
    return X, y


def gp_density(side):
    """The ``get_fns`` bundle and arguments of a float64 GP of either
    package on the CPU: ``(fns, args)``."""
    m, kw = (gj, {}) if side == "jax" else (gt, {"device": "cpu"})
    g = m.GP(D, m.covariance_functions.SquaredExponential(),
             m.mean_functions.ConstantMean(),
             m.noise_functions.GaussianNoise(constant_add=True), **kw)
    X, y = _data()
    g.update(X_new=X, y_new=y, hyp=GP_X0[None], compute_posterior=False)
    g.set_priors({"covariance_log_lengthscale": ("gaussian", (0.0, 2.0)),
                  "covariance_log_outputscale": None,
                  "noise_log_scale": ("gaussian", (-1.0, 1.0)),
                  "mean_const": None})
    return g._obj_args()


def moved(samples):
    """Per step after the first, whether the chain moved: with ``thin`` 1
    and no burn-in, the accept decisions."""
    s = np.asarray(samples)
    return np.any(s[1:] != s[:-1], axis=1)


def check(rt, rj):
    """The port's result ``rt`` against the JAX result ``rj``: the same
    keys, every array within TOL relative, non-finite entries equal (a
    fixed dimension has no spread: NaN or inf diagnostics on both sides),
    the same exit flag and accept rate."""
    assert sorted(rt) == sorted(rj)
    keys = ("samples", "f_vals", "log_priors", "R", "eff_N")
    for k in keys + (("accept_rate",) if "accept_rate" in rj else ()):
        a, b = rt[k], rj[k]
        if b is None:
            assert a is None, k
            continue
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        assert a.shape == b.shape, k
        odd = ~np.isfinite(b)
        assert np.array_equal(a[odd], b[odd], equal_nan=True), k
        a, b = a[~odd], b[~odd]
        assert np.max(np.abs(a - b), initial=0.0) <= TOL * max(
            1.0, np.max(np.abs(b), initial=0.0)), k
    assert rt["exit_flag"] == rj["exit_flag"]
