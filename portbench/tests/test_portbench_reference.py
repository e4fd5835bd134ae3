"""The float64 reference against a direct NumPy computation at N = 64:
the kernel by explicit differences, the factor, the predictive mixture,
and the NLML with its gradient (the gradient against central
differences of the NumPy NLML)."""

import numpy as np
import pytest
import torch

from portbench.reference import gp as ref

N, D, M, S = 64, 3, 20, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, D))
    y = np.sin(X).sum(1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    xs = rng.normal(size=(M, D))
    H = np.zeros((S, D + 3))
    H[:, D + 1] = np.log(0.1)
    H += 0.05 * rng.normal(size=H.shape)
    return X, y, xs, H


def _k(h, A, B):
    ell, sf2 = np.exp(h[:D]), np.exp(2 * h[D])
    diff = (A[:, None, :] - B[None, :, :]) / ell
    return sf2 * np.exp(-0.5 * (diff**2).sum(-1))


def _np_nlml(h, X, y):
    G = _k(h, X, X) + np.exp(2 * h[D + 1]) * np.eye(len(X))
    r = y[:, 0] - h[D + 2]
    _, logdet = np.linalg.slogdet(G)
    return 0.5 * r @ np.linalg.solve(G, r) + 0.5 * logdet + 0.5 * len(X) * np.log(2 * np.pi)


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def test_factor_and_mixture_match_numpy(data):
    X, y, xs, H = data
    mus, s2s = [], []
    for h in H:
        G = _k(h, X, X) + np.exp(2 * h[D + 1]) * np.eye(N)
        L = np.linalg.cholesky(G)
        alpha = np.linalg.solve(G, y - h[D + 2])
        fac = ref.Factor(_t(h), _t(X), _t(y), ref.F64)
        np.testing.assert_allclose(fac.L.numpy(), L, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(fac.alpha.numpy(), alpha, rtol=1e-9, atol=1e-10)
        assert fac.mult == 1.0
        Ks = _k(h, X, xs)
        mus.append(h[D + 2] + Ks.T @ alpha[:, 0])
        s2s.append(np.maximum(np.exp(2 * h[D]) - np.sum(Ks * np.linalg.solve(G, Ks), 0), 0))
    mus, s2s = np.array(mus), np.array(s2s)
    mu_np = mus.mean(0)
    s2_np = s2s.mean(0) + mus.var(0, ddof=1)
    mu, s2 = ref.predict_mixture(_t(H), _t(X), _t(y), _t(xs), ref.F64)
    np.testing.assert_allclose(mu.numpy(), mu_np, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(s2.numpy(), s2_np, rtol=1e-8, atol=1e-10)


def test_nlml_and_gradient_match_numpy(data):
    X, y, _, H = data
    h = H[0]
    v, g = ref.nlml_grad(_t(h), _t(X), _t(y), ref.F64)
    assert float(v) == pytest.approx(_np_nlml(h, X, y), rel=1e-12)
    eps = 1e-6
    fd = np.array([
        (_np_nlml(h + eps * e, X, y) - _np_nlml(h - eps * e, X, y)) / (2 * eps)
        for e in np.eye(D + 3)])
    np.testing.assert_allclose(g.numpy(), fd, rtol=1e-6, atol=1e-6)


def test_tf32_control_rounds_products():
    a = torch.tensor([[1.0 + 2.0**-12]], dtype=torch.float32)
    assert float(ref.TF32.mm(a, a)) == 1.0
    assert float(ref.F64.mm(a.double(), a.double())) > 1.0
