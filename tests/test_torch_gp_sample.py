"""``GP.sample``, slice sampling of exp(mixture predictive mean), the
port against ``gpyreg_tpu.GP.sample`` on the CPU in float64.

The port's GP is built by ``convert.gp_from_arrays`` from a fitted JAX
GP with 3 hyperparameter samples, so both serve the same posteriors.
Under the replay of the JAX key tree (``tests/torch_replay.py``) both
chains draw the same uniforms, so the samples agree to 1e-10: with
``beta`` 0 (the mean alone) and 0.5 (the variance too), a finite
``var_thresh``, an additive ``log_prior``, explicit ``bounds`` and
``x0``, a seed drawn from numpy's global stream (``key=None``) and an
integer key, and on a GP whose samples straddle the two stored
parametrizations (a low-noise sample is stored as a negative inverse).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
from gpyreg_tpu_torch.convert import gp_from_arrays
from torch_replay import patch_streams

torch.set_num_threads(1)

N, D = 40, 2
TOL = 1e-10
META = {"D": D, "cov_kind": "se", "mean_kind": "const",
        "noise_parameters": [1, 0, 0], "dtype": "float64"}


def _data():
    rng = np.random.default_rng(2)
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.3 * rng.normal(size=(N, 1))
    return X, y


def _port_of(g):
    return gp_from_arrays(META, g.X, g.y, None, g.get_hyperparameters(as_array=True),
                          device="cpu", bounds=(g.lower_bounds, g.upper_bounds),
                          hyper_priors=g.hyper_priors)


@pytest.fixture(scope="module")
def gps():
    X, y = _data()
    g = gj.GP(D, gj.covariance_functions.SquaredExponential(),
              gj.mean_functions.ConstantMean(),
              gj.noise_functions.GaussianNoise(constant_add=True))
    np.random.seed(0)
    hyp, _, _ = g.fit(X, y, options={"n_samples": 3, "thin": 1, "burn": 4,
                                     "init_N": 16, "opts_N": 0,
                                     "sampler_backend": "host"})
    assert hyp.shape == (3, D + 3)
    mixed = gj.GP(D, gj.covariance_functions.SquaredExponential(),
                  gj.mean_functions.ConstantMean(),
                  gj.noise_functions.GaussianNoise(constant_add=True))
    low = hyp.copy()
    low[2, D + 1] = -8.0  # sn2 = exp(-16) < 1e-6: the negative-inverse branch
    mixed.update(X_new=X, y_new=y, hyp=low)
    return {"fitted": (g, _port_of(g)), "mixed": (mixed, _port_of(mixed))}


CASES = {
    "beta0": ("fitted", dict(n_samples=30)),
    "beta_half": ("fitted", dict(n_samples=30, beta=0.5)),
    "var_thresh": ("fitted", dict(n_samples=30, var_thresh=0.02)),
    "log_prior": ("fitted", dict(n_samples=30, prior=True)),
    "bounds_x0_int_key": ("fitted", dict(n_samples=30, bounds=([-1.0, -1.5], [1.0, 1.5]),
                                         x0=[0.1, 0.2], key=11)),
    "mixed_parametrizations": ("mixed", dict(n_samples=30, beta=0.5)),
}


def _sample(g, kw, side):
    kw = dict(kw)
    if kw.pop("prior", False):
        kw["log_prior"] = ((lambda x: -0.5 * jnp.sum(x**2)) if side == "jax"
                           else (lambda x: -0.5 * torch.sum(x**2)))
    if "key" in kw and side == "jax":
        kw["key"] = jax.random.key(kw["key"])
    np.random.seed(5)
    out = g.sample(**kw)
    return out, np.random.rand()


@pytest.mark.parametrize("name", sorted(CASES))
def test_sample_equals_the_jax_sample(name, gps, monkeypatch):
    patch_streams(monkeypatch)
    which, kw = CASES[name]
    g_j, g_t = gps[which]
    if which == "mixed":
        assert [bool(p.L_chol) for p in g_t.posteriors] == [True, True, False]
    s_j, u_j = _sample(g_j, kw, "jax")
    s_t, u_t = _sample(g_t, kw, "torch")
    assert s_t.shape == (kw["n_samples"], D)
    assert np.max(np.abs(s_t - np.asarray(s_j))) <= TOL
    assert u_t == u_j  # the same draws from numpy's global stream
    if "bounds" in kw:
        assert np.all(s_t >= kw["bounds"][0]) and np.all(s_t <= kw["bounds"][1])


def test_the_density_is_the_mixture_mean_of_predict(gps):
    """At beta 0 the chain's density is the mixture mean that ``predict``
    returns; with the variance it matches ``predict``'s mixture variance."""
    _, g = gps["fitted"]
    xs = np.array([[0.3, -0.2], [1.0, 1.0]])
    mu, s2 = g.predict(xs)
    mean_only = g._mixture_mean_variance_fn(compute_var=False)
    both = g._mixture_mean_variance_fn()
    for i, x in enumerate(xs):
        m, v = mean_only(torch.tensor(x))
        assert v is None and abs(float(m) - mu[i, 0]) < 1e-12
        m, v = both(torch.tensor(x))
        assert abs(float(m) - mu[i, 0]) < 1e-12 and abs(float(v) - s2[i, 0]) < 1e-12


def test_sample_needs_the_factors(gps):
    _, g = gps["fitted"]
    h = _port_of(gps["fitted"][0])
    h.clean()
    with pytest.raises(ValueError, match="posterior factors"):
        h.sample(5)
    assert g.posteriors[0].alpha is not None
