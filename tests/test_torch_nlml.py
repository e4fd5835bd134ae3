"""The port's NLML value and posterior factors against the JAX package in
float64 on the CPU, at 1e-8 relative (the tolerance to which the JAX
package holds itself against gpyreg): several model specs, user noise,
rectified noise, ``n_real`` padding, and jitter escalation with the same
multiplier on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpyreg_tpu.core import model as MJ
from gpyreg_tpu.core import nlml as NJ
from gpyreg_tpu.ops import linalg as LJ
from gpyreg_tpu_torch.core import model as MT
from gpyreg_tpu_torch.core import nlml as NT
from gpyreg_tpu_torch.ops import linalg as LT

torch.set_num_threads(1)

RTOL = 1e-8

# (cov, mean, noise_constant, noise_user, noise_rectified, noise log-scale)
SPECS = {
    "se_const": ("se", "const", True, 0, False, np.log(0.1)),
    "m5_negquad": ("m5", "negquad", True, 0, False, np.log(0.05)),
    "rq_user_s2": ("rq", "linear", True, 1, False, np.log(0.1)),
    "m3iso_scaled_s2": ("m3_iso", "zero", False, 2, False, None),
    "se_rectified": ("se", "quad", True, 0, True, np.log(0.2)),
    "m1_low_noise": ("m1", "const", True, 0, False, -9.0),
}


def _problem(name, N=40, D=3, S=3, seed=0):
    cov, mean, nc, nu, nr, log_sn = SPECS[name]
    kw = dict(D=D, cov=cov, mean=mean, noise_constant=nc, noise_user=nu,
              noise_rectified=nr)
    spec_t, spec_j = MT.ModelSpec(**kw), MJ.ModelSpec(**kw)
    assert spec_t.hyp_N == spec_j.hyp_N
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))
    s2 = rng.uniform(0.01, 0.05, size=(N, 1)) if nu else None
    hyp = 0.2 * rng.normal(size=(S, spec_t.hyp_N))
    c = spec_t.cov_N
    if nc:
        hyp[:, c] = log_sn
    if nr:
        hyp[:, c + spec_t.noise_N - 2] = 0.0  # threshold inside the y range
        hyp[:, c + spec_t.noise_N - 1] = np.log(0.3)
    return spec_t, spec_j, X, y, s2, hyp


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_nlz_and_posterior_factors_match_jax(name):
    spec_t, spec_j, X, y, s2, hyp = _problem(name)
    nlz_t = NT.nlz(spec_t, _t(hyp), _t(X), _t(y), _t(s2))
    alpha_t, L_t, mult_t, sn2min_t = NT.posterior_factors(
        spec_t, hyp, _t(X), _t(y), _t(s2)
    )
    assert nlz_t.shape == (hyp.shape[0],) and L_t.dtype == torch.float64
    for s in range(hyp.shape[0]):
        nlz_j = NJ.nlz(spec_j, _j(hyp[s]), _j(X), _j(y), _j(s2))
        assert _rel(nlz_t[s].item(), nlz_j) < RTOL
        one = NT.nlz(spec_t, hyp[s], _t(X), _t(y), _t(s2))
        assert _rel(one.item(), nlz_j) < RTOL
        a_j, L_j, m_j, sn_j = NJ.posterior_factors(
            spec_j, _j(hyp[s]), _j(X), _j(y), _j(s2)
        )
        assert _rel(alpha_t[s].numpy(), a_j) < RTOL
        assert _rel(L_t[s].numpy(), L_j) < RTOL
        assert mult_t[s].item() == float(m_j)
        assert _rel(sn2min_t[s].item(), sn_j) < RTOL


@pytest.mark.parametrize("name", ["se_const", "se_rectified", "rq_user_s2"])
def test_padded_rows_match_jax_and_unpadded(name):
    spec_t, spec_j, X, y, s2, hyp = _problem(name, N=30, seed=1)
    pad = 10
    Xp = np.concatenate([X, np.tile(X[:1], (pad, 1))])
    yp = np.concatenate([y, np.zeros((pad, 1))])
    s2p = None if s2 is None else np.concatenate([s2, np.ones((pad, 1))])
    n = X.shape[0]
    v_t = NT.nlz(spec_t, hyp, _t(Xp), _t(yp), _t(s2p), n_real=n)
    v_un = NT.nlz(spec_t, hyp, _t(X), _t(y), _t(s2))
    a_t, L_t, _, sn_t = NT.posterior_factors(
        spec_t, hyp, _t(Xp), _t(yp), _t(s2p), n_real=n
    )
    for s in range(hyp.shape[0]):
        v_j = NJ.nlz(spec_j, _j(hyp[s]), _j(Xp), _j(yp), _j(s2p), n_real=n)
        assert _rel(v_t[s].item(), v_j) < RTOL
        assert _rel(v_t[s].item(), v_un[s].item()) < RTOL
        a_j, L_j, _, sn_j = NJ.posterior_factors(
            spec_j, _j(hyp[s]), _j(Xp), _j(yp), _j(s2p), n_real=n
        )
        assert _rel(a_t[s].numpy(), a_j) < RTOL
        assert _rel(L_t[s].numpy(), L_j) < RTOL
        assert _rel(sn_t[s].item(), sn_j) < RTOL
        assert torch.all(a_t[s, n:] == 0.0)


def _indefinite(N, neg, seed):
    """A symmetric matrix with one eigenvalue ``-neg`` and the rest in
    [1, 2]: G = K + m*sn2*I first factors at the first m*sn2 > neg."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    lam = np.concatenate([[-neg], rng.uniform(1.0, 2.0, size=N - 1)])
    return (Q * lam) @ Q.T


def test_jitter_escalation_same_mult_per_lane():
    """Each matrix of a batch escalates on its own: mults 1, 10, 1000
    and one that fails every attempt (all-NaN factor), as the vmapped
    JAX escalation gives."""
    N = 24
    sn2 = np.full((N,), 1e-3)
    negs = [-0.5, 5e-3, 0.5, 1e9]  # -0.5: positive definite already
    K = np.stack([_indefinite(N, n, i) for i, n in enumerate(negs)])
    # torch.tensor copies: jittered_cholesky overwrites K with G(1).
    L_t, mult_t = LT.jittered_cholesky(torch.tensor(K), torch.as_tensor(sn2))
    L_j, mult_j = jax.vmap(LJ.jittered_cholesky, in_axes=(0, None))(
        jnp.asarray(K), jnp.asarray(sn2)
    )
    assert mult_t.tolist() == np.asarray(mult_j).tolist() == [1.0, 10.0, 1e3, 1e9]
    for s in range(3):
        assert _rel(L_t[s].numpy(), L_j[s]) < RTOL
    assert torch.all(torch.isnan(L_t[3]))
    assert np.any(np.isnan(np.asarray(L_j[3])))

    r = np.random.default_rng(5).normal(size=(N, 1))
    q_t, h_t, m_t = LT.quad_logdet(
        torch.tensor(K[:3]), torch.as_tensor(sn2), torch.as_tensor(r)
    )
    for s in range(3):
        q_j, h_j, m_j = LJ.quad_logdet(jnp.asarray(K[s]), jnp.asarray(sn2),
                                       jnp.asarray(r))
        assert _rel(q_t[s].item(), q_j) < RTOL
        assert _rel(h_t[s].item(), h_j) < RTOL
        assert m_t[s].item() == float(m_j)


def test_neg_inverse_and_chol_solve_match_jax():
    N = 30
    K = _indefinite(N, -0.5, 7)
    L = np.linalg.cholesky(K)
    b = np.random.default_rng(8).normal(size=(N, 2))
    assert _rel(LT.neg_inverse_from_chol(torch.as_tensor(L)).numpy(),
                LJ.neg_inverse_from_chol(jnp.asarray(L))) < RTOL
    assert _rel(LT.chol_solve(torch.as_tensor(L), torch.as_tensor(b)).numpy(),
                LJ.chol_solve(jnp.asarray(L), jnp.asarray(b))) < RTOL
    Lb = torch.as_tensor(np.stack([L, L]))
    assert _rel(LT.neg_inverse_from_chol(Lb)[1].numpy(),
                LJ.neg_inverse_from_chol(jnp.asarray(L))) < RTOL


def test_float32_data_keeps_float32_and_noise_floor():
    """hyp is cast to the data dtype (gpyreg_tpu/core/nlml.py:56), and the
    float64 eps floor of a model without constant noise holds in
    float32 too (gpyreg_tpu/core/model.py:219)."""
    spec_t, spec_j, X, y, s2, hyp = _problem("m3iso_scaled_s2", S=1)
    X32, y32 = _t(X).float(), _t(y).float()
    v = NT.nlz(spec_t, hyp[0], X32, y32, _t(s2).float())
    assert v.dtype == torch.float32
    v_j = NJ.nlz(spec_j, _j(hyp[0]), _j(X).astype(jnp.float32),
                 _j(y).astype(jnp.float32), _j(s2).astype(jnp.float32))
    assert abs(v.item() - float(v_j)) < 1e-4 * abs(float(v_j))
    sn2 = MT.noise_variance(
        MT.ModelSpec(D=3, cov="se", mean="zero", noise_constant=False,
                     noise_user=0, noise_rectified=False),
        torch.zeros(0), None, None, torch.float32,
    )
    assert sn2.dtype == torch.float32
    assert sn2.item() == np.float32(np.finfo(np.float64).eps)
