"""The training path's gradients and values against the JAX package, in
float64 on the CPU at 1e-8 relative: the two linear-algebra VJPs
(``quad_logdet`` and ``jittered_cholesky``, with jitter escalation), the
NLML gradient over the model specs of tests/test_torch_nlml.py (user and
rectified noise, ``n_real`` padding), ``nlz_chain`` and ``nlz_design``
(a lane that fails to factor), and the batched entries of ``get_fns``
against a loop over single lanes.  The same numpy inputs go to both
packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpyreg_tpu.core import model as MJ
from gpyreg_tpu.core import nlml as NJ
from gpyreg_tpu.core import priors as PJ
from gpyreg_tpu.ops import linalg as LJ
from gpyreg_tpu_torch.core import model as MT
from gpyreg_tpu_torch.core import nlml as NT
from gpyreg_tpu_torch.core import priors as PT
from gpyreg_tpu_torch.ops import linalg as LT

torch.set_num_threads(1)

RTOL = 1e-8

# (cov, mean, noise_constant, noise_user, noise_rectified, noise log-scale),
# as in tests/test_torch_nlml.py.
SPECS = {
    "se_const": ("se", "const", True, 0, False, np.log(0.1)),
    "m5_negquad": ("m5", "negquad", True, 0, False, np.log(0.05)),
    "rq_user_s2": ("rq", "linear", True, 1, False, np.log(0.1)),
    "m3iso_scaled_s2": ("m3_iso", "zero", False, 2, False, None),
    "se_rectified": ("se", "quad", True, 0, True, np.log(0.2)),
    "m1_low_noise": ("m1", "const", True, 0, False, -9.0),
}


def _problem(name, N=40, D=3, S=2, seed=0):
    cov, mean, nc, nu, nr, log_sn = SPECS[name]
    kw = dict(D=D, cov=cov, mean=mean, noise_constant=nc, noise_user=nu,
              noise_rectified=nr)
    spec_t, spec_j = MT.ModelSpec(**kw), MJ.ModelSpec(**kw)
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
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _data_args(X, y, s2, conv):
    return (conv(X), conv(y)) + (() if s2 is None else (conv(s2),))


def _indefinite(N, neg, seed):
    """A symmetric matrix with one eigenvalue ``-neg`` and the rest in
    [1, 2]: G = K + m*sn2*I first factors at the first m*sn2 > neg."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    lam = np.concatenate([[-neg], rng.uniform(1.0, 2.0, size=N - 1)])
    return (Q * lam) @ Q.T


# Eigenvalue shift -> the multiplier both sides settle on at sn2 = 1e-3.
ESCALATION = {"mult_1": (-0.5, 1.0), "mult_10": (5e-3, 10.0),
              "mult_1000": (0.5, 1e3)}


@pytest.mark.parametrize("case", sorted(ESCALATION))
def test_quad_logdet_vjp_matches_jax(case):
    """Gradient of a*quad + b*halflogdet in K, sn2 and r against
    ``jax.grad`` of the JAX ``quad_logdet`` custom VJP."""
    neg, mult = ESCALATION[case]
    N = 24
    rng = np.random.default_rng(3)
    K = _indefinite(N, neg, 11)
    sn2 = rng.uniform(0.5e-3, 1.5e-3, size=(N,))
    sn2[0] = 1e-3
    r = rng.normal(size=(N, 1))
    a, b = 0.7, -1.3
    if neg > 0:  # the negative eigenvalue needs mult * sn2 > neg
        sn2[:] = 1e-3

    def f_j(K, s, r):
        q, h, m = LJ.quad_logdet(K, s, r)
        return a * q + b * h, m

    (v_j, m_j), g_j = jax.value_and_grad(f_j, argnums=(0, 1, 2),
                                         has_aux=True)(_j(K), _j(sn2), _j(r))
    Kt, st, rt = (torch.tensor(v, requires_grad=True) for v in (K, sn2, r))
    q, h, m = LT.quad_logdet(Kt.clone(), st, rt)  # K is overwritten
    (a * q + b * h).backward()
    assert m.item() == float(m_j) == mult
    assert _rel((a * q + b * h).item(), v_j) < RTOL
    for gt_, gj_ in zip((Kt.grad, st.grad, rt.grad), g_j):
        assert _rel(gt_.numpy(), gj_) < RTOL


@pytest.mark.parametrize("case", sorted(ESCALATION))
def test_jittered_cholesky_vjp_matches_jax(case):
    """Gradient of sum(W * L) in K and sn2 against ``jax.grad`` of the
    JAX ``jittered_cholesky`` custom VJP (``_cholesky_vjp_core``)."""
    neg, mult = ESCALATION[case]
    N = 20
    K = _indefinite(N, neg, 12)
    sn2 = np.full((N,), 1e-3)
    W = np.tril(np.random.default_rng(4).normal(size=(N, N)))

    def f_j(K, s):
        L, m = LJ.jittered_cholesky(K, s)
        return jnp.sum(_j(W) * L), m

    (v_j, m_j), g_j = jax.value_and_grad(f_j, argnums=(0, 1),
                                         has_aux=True)(_j(K), _j(sn2))
    Kt, st = (torch.tensor(v, requires_grad=True) for v in (K, sn2))
    L, m = LT.jittered_cholesky(Kt.clone(), st)
    v = torch.sum(_t(W) * L)
    v.backward()
    assert m.item() == float(m_j) == mult
    assert _rel(v.item(), v_j) < RTOL
    assert _rel(Kt.grad.numpy(), g_j[0]) < RTOL
    assert _rel(st.grad.numpy(), g_j[1]) < RTOL


@pytest.mark.parametrize("name", sorted(SPECS))
def test_nlz_gradient_matches_jax(name):
    """``get_fns(...)["nlz_grad"]`` on a stack of two vectors (one lane at
    a time) against ``jax.value_and_grad`` of the JAX ``nlz``."""
    spec_t, spec_j, X, y, s2, hyp = _problem(name)
    fns = NT.get_fns(spec_t, s2 is not None, False)
    v_t, g_t = fns["nlz_grad"](hyp, *_data_args(X, y, s2, _t))
    assert v_t.shape == (2,) and g_t.shape == hyp.shape
    assert g_t.dtype == torch.float64
    vg_j = jax.value_and_grad(
        lambda h: NJ.nlz(spec_j, h, _j(X), _j(y), _j(s2)))
    for s in range(hyp.shape[0]):
        v_j, g_j = vg_j(_j(hyp[s]))
        assert _rel(v_t[s].item(), v_j) < RTOL
        assert _rel(g_t[s].numpy(), g_j) < RTOL


@pytest.mark.parametrize("name", ["se_const", "se_rectified", "rq_user_s2"])
def test_padded_nlz_gradient_matches_jax_and_unpadded(name):
    """``n_real`` padding keeps the value and the gradient of the
    unpadded NLML, on both sides."""
    spec_t, spec_j, X, y, s2, hyp = _problem(name, N=30, seed=1)
    pad = 10
    Xp = np.concatenate([X, np.tile(X[:1], (pad, 1))])
    yp = np.concatenate([y, np.zeros((pad, 1))])
    s2p = None if s2 is None else np.concatenate([s2, np.ones((pad, 1))])
    n = X.shape[0]
    padded = NT.get_fns(spec_t, s2 is not None, False, padded=True)
    plain = NT.get_fns(spec_t, s2 is not None, False)
    v_t, g_t = padded["nlz_grad"](hyp, *_data_args(Xp, yp, s2p, _t), n)
    v_u, g_u = plain["nlz_grad"](hyp, *_data_args(X, y, s2, _t))
    vg_j = jax.value_and_grad(
        lambda h: NJ.nlz(spec_j, h, _j(Xp), _j(yp), _j(s2p), n_real=n))
    for s in range(hyp.shape[0]):
        v_j, g_j = vg_j(_j(hyp[s]))
        assert _rel(v_t[s].item(), v_j) < RTOL
        assert _rel(g_t[s].numpy(), g_j) < RTOL
        assert _rel(g_t[s].numpy(), g_u[s].numpy()) < RTOL
        assert _rel(v_t[s].item(), v_u[s].item()) < RTOL


def _prior_table(hyp_N, rng):
    """Gaussian priors on every hyperparameter, bounds at +-5."""
    table = {k: np.full((hyp_N,), np.nan) for k in ("mu", "sigma", "df", "a", "b")}
    table["mu"] = rng.normal(size=(hyp_N,))
    table["sigma"] = rng.uniform(0.5, 2.0, size=(hyp_N,))
    table["df"] = np.zeros((hyp_N,))
    return table, np.full((hyp_N,), -5.0), np.full((hyp_N,), 5.0)


@pytest.mark.parametrize("name", ["se_const", "rq_user_s2"])
def test_prior_entries_match_jax(name):
    """The objective entries with a hyperprior (``obj*``, ``log_post*``,
    ``log_prior_raw``, ``obj_design_raw``) against the JAX bundle."""
    spec_t, spec_j, X, y, s2, hyp = _problem(name, seed=2)
    table, lb, ub = _prior_table(spec_t.hyp_N, np.random.default_rng(9))
    has_s2 = s2 is not None
    fns_t = NT.get_fns(spec_t, has_s2, True)
    fns_j = NJ.get_fns(spec_j, has_s2, True)
    args_t = _data_args(X, y, s2, _t) + (
        PT.build_prior_pack(table, lb, ub, log_norm=0.3),)
    args_j = _data_args(X, y, s2, _j) + (
        PJ.build_prior_pack(table, lb, ub, log_norm=0.3),)
    v_t, g_t = fns_t["obj_grad_batch"](hyp, *args_t)
    v_j, g_j = fns_j["obj_grad_batch"](_j(hyp), *args_j)
    assert _rel(v_t.numpy(), v_j) < RTOL and _rel(g_t.numpy(), g_j) < RTOL
    assert _rel(fns_t["obj_batch"](hyp, *args_t).numpy(), v_j) < RTOL
    h = hyp[0]
    for key in ("obj", "log_post_raw", "log_prior_raw", "log_post_chain_raw",
                "obj_design_raw", "obj_raw"):
        assert _rel(float(fns_t[key](h, *args_t)),
                    float(fns_j[key](_j(h), *args_j))) < RTOL, key
    v1, g1 = fns_t["obj_grad"](h, *args_t)
    assert _rel(v1.item(), v_j[0]) < RTOL and _rel(g1.numpy(), g_j[0]) < RTOL
    # log_post_raw is differentiable by autograd, as the samplers need.
    ht = torch.tensor(h, requires_grad=True)
    fns_t["log_post_raw"](ht, *args_t).backward()
    assert _rel(ht.grad.numpy(), -np.asarray(g_j[0])) < RTOL


def _degenerate_lane(spec_t, X, hyp):
    """X with a block of repeated rows and one lane at a noise so small
    that G = K + sn2 I fails to factor at the nominal noise."""
    Xd = X.copy()
    Xd[1:12] = Xd[0]
    h = np.concatenate([hyp, hyp[:1]])
    h[-1, spec_t.cov_N] = -25.0
    return Xd, h


def test_nlz_chain_and_design_match_jax():
    """``nlz_chain`` gives ``nlz``'s value and multiplier on its lean
    schedule, escalation included; ``nlz_design`` is +inf for the lane
    that does not factor at the nominal noise, as in the JAX package."""
    spec_t, spec_j, X, y, _, hyp = _problem("se_const", seed=3)
    Xd, h = _degenerate_lane(spec_t, X, hyp)
    chain = NT.nlz_chain(spec_t, h, _t(Xd), _t(y), None)
    design = NT.nlz_design(spec_t, h, _t(Xd), _t(y), None)
    full = NT.nlz(spec_t, h, _t(Xd), _t(y), None)
    _, _, _, mult, _, _ = NT.gp_parts(spec_t, h, _t(Xd), _t(y), None)
    assert mult[-1].item() > 1.0 and torch.all(mult[:-1] == 1.0)
    assert _rel(chain.numpy(), full.numpy()) < RTOL
    assert torch.isinf(design[-1]) and design[-1].item() > 0
    assert _rel(design[:-1].numpy(), full[:-1].numpy()) < RTOL
    # Where the escalation stops on that lane is decided by rounding (the
    # repeated rows leave pivots of sn2 plus rounding), so the packages
    # agree there on the failure at the nominal noise only; the multiplier
    # sequence itself is held to the JAX package on matrices with a clear
    # margin in test_torch_nlml.py::test_jitter_escalation_same_mult_per_lane.
    assert float(NJ.gp_parts(spec_j, _j(h[-1]), _j(Xd), _j(y), None)[3]) > 1.0
    d_j = NJ.nlz_design(spec_j, _j(h[-1]), _j(Xd), _j(y), None)
    assert np.isposinf(float(d_j))
    for s in range(h.shape[0] - 1):
        c_j = NJ.nlz_chain(spec_j, _j(h[s]), _j(Xd), _j(y), None)
        assert _rel(chain[s].item(), c_j) < RTOL
        d_j = NJ.nlz_design(spec_j, _j(h[s]), _j(Xd), _j(y), None)
        assert _rel(design[s].item(), d_j) < RTOL
    # Single vectors give scalars.
    assert NT.nlz_chain(spec_t, h[0], _t(Xd), _t(y), None).shape == ()


@pytest.mark.parametrize("name", ["m5_negquad", "m3iso_scaled_s2"])
def test_batched_entries_match_single_lanes(name):
    """``obj_batch``, ``obj_grad_batch`` and ``post_batch`` on a stack of
    three vectors equal ``obj``, ``obj_grad`` and ``post`` lane by lane."""
    spec_t, _, X, y, s2, hyp = _problem(name, S=3, seed=4)
    table, lb, ub = _prior_table(spec_t.hyp_N, np.random.default_rng(5))
    fns = NT.get_fns(spec_t, s2 is not None, True)
    data = _data_args(X, y, s2, _t)
    args = data + (PT.build_prior_pack(table, lb, ub),)
    vb = fns["obj_batch"](hyp, *args)
    vgb, ggb = fns["obj_grad_batch"](hyp, *args)
    post = fns["post_batch"](hyp, *data)
    for s in range(hyp.shape[0]):
        v1, g1 = fns["obj_grad"](hyp[s], *args)
        assert _rel(vb[s].item(), fns["obj"](hyp[s], *args).item()) < 1e-12
        assert _rel(vgb[s].item(), v1.item()) < 1e-12
        assert _rel(ggb[s].numpy(), g1.numpy()) < 1e-12
        for a, b in zip(post, fns["post"](hyp[s], *data)):
            assert _rel(a[s].numpy(), b.numpy()) < 1e-12
