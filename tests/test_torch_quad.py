"""The port's Bayesian quadrature (``GP.quad``,
``serving.quad_moments``) against the JAX package's on the CPU, in
float64: se and se_iso kernels; zero, constant and negative-quadratic
means; the Cholesky, inverse and mixed parametrizations; with and
without ``compute_var`` and ``separate_samples``; one sigma for every
measure or one a measure.  1e-8 relative.  The refusals raise JAX's
messages.
"""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch import gp as gp_mod
from torch_serving_cases import RTOL, make, pair, rel

torch.set_num_threads(1)

PARAMS = {
    "chol": (-2.3, -2.2, -2.0),
    "inv": (-8.0, -8.1, -7.9),
    "mixed": (-2.0, -9.0, -2.3),
}


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("mean", ["zero", "const", "negquad"])
@pytest.mark.parametrize("cov", ["se", "se_iso"])
def test_quad_matches_jax(cov, mean, params):
    g, t, rng = pair(PARAMS[params], cov=cov, mean=mean, D=3, N=40)
    mu = rng.uniform(-2, 2, (6, 3))
    sigma_rows = rng.uniform(0.2, 0.8, (6, 3))
    for kw in (dict(compute_var=True, separate_samples=True),
               dict(compute_var=True),
               dict(separate_samples=True)):
        for sigma in (0.5, sigma_rows):
            oj, ot = g.quad(mu, sigma, **kw), t.quad(mu, sigma, **kw)
            oj = oj if kw.get("compute_var") else (oj,)
            ot = ot if kw.get("compute_var") else (ot,)
            for a, b in zip(ot, oj):
                assert a.shape == b.shape
                assert rel(a, b) < RTOL, (kw, np.size(sigma))
    F = t.quad(mu, 0.5)
    assert F.shape == (6, 1)


def test_quad_takes_one_point_and_one_value():
    g, t, _ = pair(PARAMS["chol"])
    for mu in (0.3, np.array([0.3, -0.2])):
        Fj, Vj = g.quad(mu, 0.4, compute_var=True)
        Ft, Vt = t.quad(mu, 0.4, compute_var=True)
        assert Ft.shape == (1, 1)
        assert rel(Ft, Fj) < RTOL and rel(Vt, Vj) < RTOL


def test_quad_chunks_its_measures(monkeypatch):
    """Measures in chunks of 2 (a budget of 2 N D elements) give the
    unchunked result."""
    _, t, rng = pair(PARAMS["mixed"], D=2, N=30)
    mu = rng.uniform(-2, 2, (7, 2))
    whole = t.quad(mu, 0.5, compute_var=True, separate_samples=True)
    monkeypatch.setattr(gp_mod, "_PREDICT_CHUNK_ELEMS", 2 * 30 * 2)
    parts = t.quad(mu, 0.5, compute_var=True, separate_samples=True)
    for a, b in zip(parts, whole):
        assert rel(a, b) < RTOL


def _refusal(pkg, cov="se", mean="const"):
    rng = np.random.default_rng(0)
    gp = make(pkg, 2, cov=cov, mean=mean)
    X = rng.uniform(-3, 3, (20, 2))
    y = np.sin(X.sum(1, keepdims=True))
    hyp = np.zeros((1, gp._hyp_N()))
    hyp[0, gp._hyp_counts()[0]] = -2.0
    gp.update(X_new=X, y_new=y, hyp=hyp)
    return gp


@pytest.mark.parametrize("cov,mean", [("m5", "const"), ("se", "linear")])
def test_quad_refuses_as_jax(cov, mean):
    msgs = []
    for pkg in (gj, gt):
        if mean == "linear":
            gp = pkg.GP(2, pkg.covariance_functions.SquaredExponential(),
                        pkg.mean_functions.LinearMean(),
                        pkg.noise_functions.GaussianNoise(constant_add=True),
                        **({} if pkg is gj else {"device": "cpu"}))
            rng = np.random.default_rng(0)
            X = rng.uniform(-3, 3, (20, 2))
            hyp = np.zeros((1, gp._hyp_N()))
            gp.update(X_new=X, y_new=np.sin(X[:, :1]), hyp=hyp)
        else:
            gp = _refusal(pkg, cov=cov, mean=mean)
        with pytest.raises(ValueError) as e:
            gp.quad(np.zeros((1, 2)), 0.5)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_quad_without_factors_raises():
    gp = _refusal(gt)
    gp.clean()
    with pytest.raises(ValueError, match="Bayesian quadrature requires"):
        gp.quad(np.zeros((1, 2)), 0.5)
