"""The port's kernel math and host-side model objects against the JAX
package, in float64 on the CPU: ``ops/kernels.kernel_matrix`` for all 9
kinds (self, cross and diag) at 1e-12 relative, and the covariance,
mean and noise objects' ``compute`` on the same inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpyreg_tpu as gj
from gpyreg_tpu.ops import kernels as KJ
import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch.convert import covariance_from_kind, mean_from_kind
from gpyreg_tpu_torch.ops import kernels as KT

torch.set_num_threads(1)

COVS = ["se", "m1", "m3", "m5", "rq", "se_iso", "m1_iso", "m3_iso", "m5_iso"]
MEANS = ["zero", "const", "negquad", "linear", "quad", "posquad",
         "se_mean", "negse_mean"]
RTOL = 1e-12


def _inputs(n_hyp, N=40, M=25, D=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    Z = rng.normal(size=(M, D))
    hyp = 0.3 * rng.normal(size=(n_hyp,))
    return X, Z, hyp


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = np.maximum(np.max(np.abs(b)), 1e-300)
    assert np.max(np.abs(a - b)) <= rtol * scale


@pytest.mark.parametrize("cov", COVS)
def test_kernel_matrix_matches_jax(cov):
    X, Z, hyp = _inputs(KT.cov_hyp_count(cov, 3))
    assert KT.cov_hyp_count(cov, 3) == KJ.cov_hyp_count(cov, 3)
    Xt, Zt, ht = (torch.as_tensor(a) for a in (X, Z, hyp))
    for kw_t, kw_j in (
        ({}, {}),
        ({"Z": Zt}, {"Z": jnp.asarray(Z)}),
        ({"diag": True}, {"diag": True}),
    ):
        K_t = KT.kernel_matrix(cov, ht, Xt, **kw_t)
        K_j = KJ.kernel_matrix(cov, jnp.asarray(hyp), jnp.asarray(X), **kw_j)
        assert K_t.dtype == torch.float64
        _close(K_t.numpy(), K_j)


def test_sq_dist_diagonal_clamp_and_safe_sqrt():
    X, Z, _ = _inputs(1, N=30)
    d_t = KT.sq_dist(torch.as_tensor(X))
    assert torch.all(torch.diagonal(d_t) == 0.0) and torch.all(d_t >= 0.0)
    _close(d_t.numpy(), KJ.sq_dist(jnp.asarray(X)))
    _close(KT.sq_dist(torch.as_tensor(X), torch.as_tensor(Z)).numpy(),
           KJ.sq_dist(jnp.asarray(X), jnp.asarray(Z)))
    d = torch.tensor([0.0, 0.25, 4.0], requires_grad=True)
    KT._safe_sqrt(d).sum().backward()
    assert d.grad.tolist() == [0.0, 1.0, 0.25]


@pytest.mark.parametrize("cov", COVS)
def test_covariance_objects_match_jax(cov):
    ct = covariance_from_kind(cov)
    cj = {
        "se": gj.covariance_functions.SquaredExponential(),
        "rq": gj.covariance_functions.RationalQuadraticARD(),
        "se_iso": gj.isotropic_covariance_functions.SquaredExponentialIsotropic(),
    }.get(cov)
    if cj is None:
        deg = int(cov[1])
        cj = (gj.isotropic_covariance_functions.MaternIsotropic(deg)
              if cov.endswith("_iso") else gj.covariance_functions.Matern(deg))
    assert ct._kind == cj._kind
    assert ct.hyperparameter_count(3) == cj.hyperparameter_count(3)
    assert ct.hyperparameter_info(3) == cj.hyperparameter_info(3)
    X, Z, hyp = _inputs(ct.hyperparameter_count(3), N=12, M=7, seed=1)
    _close(ct.compute(hyp, X, Z), cj.compute(hyp, X, Z))
    _close(ct.compute(hyp, X, compute_diag=True),
           cj.compute(hyp, X, compute_diag=True))
    K_t, dK_t = ct.compute(hyp, X, compute_grad=True)
    K_j, dK_j = cj.compute(hyp, X, compute_grad=True)
    _close(K_t, K_j)
    _close(dK_t, dK_j, rtol=1e-10)


@pytest.mark.parametrize("kind", MEANS)
def test_mean_objects_match_jax(kind):
    mt = mean_from_kind(kind)
    mj = {
        "zero": gj.mean_functions.ZeroMean, "const": gj.mean_functions.ConstantMean,
        "negquad": gj.mean_functions.NegativeQuadratic,
        "linear": gj.mean_functions.LinearMean,
        "quad": gj.mean_functions.QuadraticMean,
        "posquad": gj.mean_functions.PositiveQuadratic,
        "se_mean": gj.mean_functions.SquaredExponentialMean,
        "negse_mean": gj.mean_functions.NegativeSquaredExponentialMean,
    }[kind]()
    assert mt._kind == mj._kind
    assert mt.hyperparameter_info(3) == mj.hyperparameter_info(3)
    X, _, hyp = _inputs(mt.hyperparameter_count(3), N=15, seed=2)
    m_t, dm_t = mt.compute(hyp, X, compute_grad=True)
    m_j, dm_j = mj.compute(hyp, X, compute_grad=True)
    _close(m_t, m_j)
    if kind != "zero":
        _close(dm_t, dm_j)


def test_custom_mean_and_noise_match_jax():
    def bowl_t(h, X):
        return h[0] - torch.sum((X - h[1]) ** 2, dim=1)

    def bowl_j(h, X):
        return h[0] - jnp.sum((X - h[1]) ** 2, axis=1)

    mt = gt.mean_functions.CustomMean(bowl_t, 2, name="torch_test_bowl")
    mj = gj.mean_functions.CustomMean(bowl_j, 2, name="torch_test_bowl")
    X, _, hyp = _inputs(2, N=10, seed=3)
    for a, b in zip(mt.compute(hyp, X, compute_grad=True),
                    mj.compute(hyp, X, compute_grad=True)):
        _close(a, b)

    rng = np.random.default_rng(4)
    y = rng.normal(size=(10, 1))
    s2 = rng.uniform(0.1, 1.0, size=(10, 1))
    flags = dict(constant_add=True, user_provided_add=True,
                 scale_user_provided=True,
                 rectified_linear_output_dependent_add=True)
    nt = gt.noise_functions.GaussianNoise(**flags)
    nj = gj.noise_functions.GaussianNoise(**flags)
    assert np.array_equal(nt.parameters, nj.parameters)
    assert nt.hyperparameter_info() == nj.hyperparameter_info()
    h = np.array([-1.0, 0.3, 0.2, -0.5])
    for a, b in zip(nt.compute(h, X, y, s2, compute_grad=True),
                    nj.compute(h, X, y, s2, compute_grad=True)):
        _close(a, b)
