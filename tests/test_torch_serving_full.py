"""The port's full-covariance and random-draw serving against the JAX
package's on the CPU, in float64: ``ops.linalg.robust_cholesky``,
``GP.predict_full``, ``GP.random_function`` and ``GP.predict_quantile``.

Same numpy inputs on both sides; 1e-8 relative.  ``random_function``
draws from numpy's global stream in the JAX package's order, so under
the same ``np.random.seed`` both packages draw the same function and
leave the stream in the same state.
"""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
from gpyreg_tpu.ops.linalg import robust_cholesky as jax_robust_cholesky
import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch.ops import linalg as TL
from torch_serving_cases import RTOL, make, pair, rel

torch.set_num_threads(1)

PARAMS = {
    "chol": (-2.3, -2.2, -2.0),
    "inv": (-8.0, -8.1, -7.9),
    "mixed": (-2.0, -9.0, -2.3),
}


def _spectral(w, seed):
    """Q diag(w) Q^T with a random orthogonal Q."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(len(w),) * 2))
    return (q * np.asarray(w)) @ q.T


ROBUST = {
    # name -> (matrix, route, compare the factor itself)
    "spd": (_spectral([4.0, 2.0, 1.0, 0.5, 0.1], 0), "cholesky", True),
    "dropped_negative": (_spectral([3.0, 2.0, 1.0, 0.5, -1e-18], 1), "eigh",
                         True),
    "kept_negative": (_spectral([3.0, 2.0, 1.0, -0.5, 0.2], 2), "eigh", True),
    "repeated": (_spectral([2.0, 2.0, 1.0, 1.0, -1e-18], 3), "eigh", False),
    "spd_ill": (_spectral([1e4, 1.0, 1e-2, 1e-3, 1e-4], 4), "cholesky", True),
    "spd_diagonal": (np.diag([3.0, 1.0, 0.5, 2.0, 0.25]), "cholesky", True),
    "kept_negative_large": (_spectral([1.0, -3.0, 0.5, 0.2, 0.1], 5), "eigh",
                            True),
}


@pytest.mark.parametrize("name", sorted(ROBUST))
def test_robust_cholesky_matches_jax(name):
    A, route, same_factor = ROBUST[name]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        T = TL.robust_cholesky(torch.tensor(A)).numpy()
    routes = [e.name for e in prof.events()
              if e.name.startswith("gpyreg.robust_cholesky.")]
    assert routes == [f"gpyreg.robust_cholesky.{route}"]
    Tj = np.asarray(jax_robust_cholesky(A))
    if name.startswith("kept_negative"):
        assert not np.any(T) and not np.any(Tj)
        return
    assert rel(T.T @ T, Tj.T @ Tj) < RTOL
    if same_factor:
        assert rel(T, Tj) < RTOL
    if route == "cholesky":
        assert np.allclose(np.tril(T, -1), 0.0)
        assert rel(T.T @ T, A) < RTOL


@pytest.mark.parametrize("add_noise", [False, True])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_predict_full_matches_jax(name, add_noise):
    g, t, rng = pair(PARAMS[name])
    xs = rng.uniform(-3, 3, (9, 2))
    (mj, cj), (mt, ct) = (m.predict_full(xs, add_noise=add_noise)
                          for m in (g, t))
    assert mt.shape == (9, 3) and ct.shape == (9, 9, 3)
    assert rel(mt, mj) < RTOL and rel(ct, cj) < RTOL
    assert np.array_equal(ct, ct.transpose(1, 0, 2))
    # Its diagonal is predict's variance of each sample.
    _, s2 = t.predict(xs, separate_samples=True, add_noise=add_noise)
    diag = np.einsum("iis->is", ct)
    assert rel(np.maximum(diag, 0), s2) < RTOL


def _heteroskedastic(pkg):
    """The GP of tests/test_extras.py:100 (user noise per row)."""
    rng = np.random.default_rng(5)
    N, D = 30, 2
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, 1, keepdims=True))
    s2 = 0.05 + 0.1 * rng.uniform(size=(N, 1))
    gp = make(pkg, D, user_noise=True)
    hyp = np.concatenate([[0.3, 0.3], [0.0], [-2.0], [0.0]])[None, :]
    gp.update(X_new=X, y_new=y, s2_new=s2, hyp=hyp)
    xs = rng.uniform(-3, 3, (7, D))
    s2_star = 0.2 + 0.1 * rng.uniform(size=(7, 1))
    return gp, xs, s2_star


def test_predict_full_heteroskedastic_noise_goes_on_the_diagonal():
    out = {}
    for pkg in (gj, gt):
        gp, xs, s2_star = _heteroskedastic(pkg)
        out[pkg] = [gp.predict_full(xs, s2_star=s2_star, add_noise=a)
                    for a in (False, True)]
    for a in (0, 1):
        for k in (0, 1):
            assert rel(out[gt][a][k], out[gj][a][k]) < RTOL
    delta = out[gt][1][1][:, :, 0] - out[gt][0][1][:, :, 0]
    assert np.max(np.abs(delta - np.diag(np.diag(delta)))) == 0.0
    assert np.all(np.diag(delta) > 0)


def _prior_pair(seed=0):
    rng = np.random.default_rng(seed)
    g, t = make(gj, 2), make(gt, 2)
    hyp = 0.1 * rng.normal(size=(2, g._hyp_N()))
    for m in (g, t):
        m.update(hyp=hyp)
    return g, t, rng


def test_predict_full_of_the_prior_matches_jax():
    g, t, rng = _prior_pair()
    xs = rng.uniform(-3, 3, (9, 2))
    (mj, cj), (mt, ct) = g.predict_full(xs), t.predict_full(xs)
    assert rel(mt, mj) < RTOL and rel(ct, cj) < RTOL


@pytest.mark.parametrize("add_noise", [False, True])
@pytest.mark.parametrize("name", sorted(PARAMS) + ["prior"])
def test_random_function_draws_what_jax_draws(name, add_noise):
    if name == "prior":
        g, t, rng = _prior_pair()
    else:
        g, t, rng = pair(PARAMS[name])
    xs = rng.uniform(-3, 3, (12, 2))
    draws, after = [], []
    for m in (g, t):
        np.random.seed(11)
        draws.append(m.random_function(xs, add_noise=add_noise))
        after.append(np.random.random())
    fj, ft = draws
    assert ft.shape == (12, 1) and ft.dtype == fj.dtype
    assert rel(ft, fj) < RTOL
    assert after[0] == after[1]


def test_random_function_of_a_float32_gp_is_float32():
    _, t, rng = pair(PARAMS["chol"])
    t32 = make(gt, 2, dtype=np.float32)
    t32.update(X_new=t.X, y_new=t.y, hyp=t.get_hyperparameters(as_array=True))
    np.random.seed(0)
    f = t32.random_function(rng.uniform(-3, 3, (5, 2)))
    assert f.dtype == np.float32 and np.all(np.isfinite(f))


@pytest.mark.parametrize("observed", [True, False])
@pytest.mark.parametrize("name", sorted(PARAMS))
def test_predict_quantile_matches_jax(name, observed):
    g, t, rng = pair(PARAMS[name])
    xs = rng.uniform(-3, 3, (10, 2))
    for q in ([0.1, 0.5, 0.9], 0.3):
        qj = g.predict_quantile(q, xs, observed=observed)
        qt = t.predict_quantile(q, xs, observed=observed)
        assert qt.shape == qj.shape
        assert rel(qt, qj) < RTOL
    assert np.all(np.diff(t.predict_quantile([0.1, 0.5, 0.9], xs), axis=1) > 0)
