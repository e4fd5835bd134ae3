"""The GP's likelihood surface against ``gpyreg_tpu.GP`` in float64 on
the CPU at 1e-8 relative: ``log_likelihood`` and ``log_posterior`` with
and without ``compute_grad``, the reference-private shims
``_GP__compute_nlZ`` and ``_GP__compute_log_priors``, the batched
objective, and a GP saved by the JAX package and loaded into the port.
Also: the port's entry points put their tensors on the card unless asked
for the CPU, and raise, without falling back, where there is no card."""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch.convert import gp_from_arrays

torch.set_num_threads(1)

RTOL = 1e-8

PRIORS = {
    "covariance_log_lengthscale": ("gaussian", (0.1, 1.5)),
    "covariance_log_outputscale": ("student_t", (0.0, 2.0, 4.0)),
    "covariance_log_shape": None,
    "noise_log_scale": ("smoothbox", (-4.0, -1.0, 0.5)),
    "mean_const": ("smoothbox_student_t", (-1.0, 1.0, 0.5, 3.0)),
}
BOUNDS = {
    "covariance_log_lengthscale": (-3.0, 3.0),
    "covariance_log_outputscale": (-4.0, 4.0),
    "covariance_log_shape": (-2.0, 2.0),
    "noise_log_scale": (-6.0, 0.0),
    "mean_const": (-np.inf, np.inf),
}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _pair(with_prior, N=45, D=3, seed=0):
    """The same GP in both packages (RQ-ARD, constant mean, constant
    noise), with data and 2 hyperparameter vectors."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))

    def make(m, **kw):
        return m.GP(D, m.covariance_functions.RationalQuadraticARD(),
                    m.mean_functions.ConstantMean(),
                    m.noise_functions.GaussianNoise(constant_add=True), **kw)

    g_j, g_t = make(gj), make(gt, device="cpu")
    hyp = 0.2 * rng.normal(size=(2, g_j._hyp_N()))
    hyp[:, D + 2] = np.log(0.1)
    for g in (g_j, g_t):
        if with_prior:
            g.set_priors(PRIORS)
            g.set_bounds(BOUNDS)
        g.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=False)
    return g_j, g_t, hyp


@pytest.mark.parametrize("with_prior", [False, True])
def test_likelihood_surface_matches_jax(with_prior):
    g_j, g_t, hyp = _pair(with_prior)
    assert g_t.no_prior is (not with_prior)
    for h in hyp:
        assert _rel(g_t.log_likelihood(h), g_j.log_likelihood(h)) < RTOL
        assert _rel(g_t.log_posterior(h), g_j.log_posterior(h)) < RTOL
        for fn in ("log_likelihood", "log_posterior"):
            v_t, d_t = getattr(g_t, fn)(h, compute_grad=True)
            v_j, d_j = getattr(g_j, fn)(h, compute_grad=True)
            assert _rel(v_t, v_j) < RTOL and _rel(d_t, d_j) < RTOL, fn
        for prior in (False, True):
            v_t, d_t = g_t._GP__compute_nlZ(h, True, prior)
            v_j, d_j = g_j._GP__compute_nlZ(h, True, prior)
            assert _rel(v_t, v_j) < RTOL and _rel(d_t, d_j) < RTOL
            assert _rel(g_t._GP__compute_nlZ(h, False, prior), v_j) < RTOL
        lp_t, dlp_t = g_t._GP__compute_log_priors(h, True)
        lp_j, dlp_j = g_j._GP__compute_log_priors(h, True)
        assert _rel(lp_t, lp_j) < RTOL or lp_t == lp_j == 0.0
        assert _rel(dlp_t, dlp_j) < RTOL or not np.any(dlp_j)
        assert _rel(g_t._GP__compute_log_priors(h, False), lp_j) < RTOL \
            or lp_j == 0.0
    # A dict of hyperparameters is taken as the array is.
    d = g_t.hyperparameters_to_dict(hyp[:1])[0]
    assert g_t.log_posterior(d) == g_t.log_posterior(hyp[0])


def test_objective_batch_matches_jax():
    """``_objective_batch`` against the JAX GP, and against the scalar
    objective lane by lane."""
    g_j, g_t, hyp = _pair(True, seed=1)
    hyps = np.concatenate([hyp, hyp + 0.05, hyp - 0.05])
    out_t = g_t._objective_batch(hyps)
    assert out_t.shape == (6,) and out_t.dtype == np.float64
    assert _rel(out_t, g_j._objective_batch(hyps)) < RTOL
    v, dv = g_t._objective(hyps[0], grad=True, swap_sign=True)
    assert _rel(v, g_j.log_posterior(hyps[0])) < RTOL
    lanes = np.array([g_t._objective(h) for h in hyps])
    assert _rel(out_t, lanes) < 1e-12


def test_jax_saved_gp_gives_the_same_log_posterior(tmp_path):
    """The bounds, prior table and ``no_prior`` of a JAX-saved GP come
    across ``GP.load``; so do the normalization constants."""
    g_j, _, hyp = _pair(True, seed=2)
    g_j.update(hyp=hyp, compute_posterior=True)
    g_j.save(tmp_path / "prior.npz")
    g_t = gt.GP.load(tmp_path / "prior.npz", device="cpu")
    assert g_t.no_prior is False
    assert _rel(g_t.normalization_constants, g_j.normalization_constants) < 1e-14
    assert np.array_equal(g_t.lower_bounds, g_j.lower_bounds)
    for h in hyp:
        v_t, d_t = g_t.log_posterior(h, compute_grad=True)
        v_j, d_j = g_j.log_posterior(h, compute_grad=True)
        assert _rel(v_t, v_j) < RTOL and _rel(d_t, d_j) < RTOL
    # And the port's own save carries them back.
    g_t.save(tmp_path / "again.npz")
    back = gt.GP.load(tmp_path / "again.npz", device="cpu")
    assert back.log_posterior(hyp[0]) == g_t.log_posterior(hyp[0])


def test_default_device_is_the_card_and_never_falls_back(tmp_path,
                                                         monkeypatch):
    """Without ``device``, ``GP``, ``GP.load`` and ``gp_from_arrays`` ask
    for CUDA; with no card they raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parts = (2, gt.covariance_functions.SquaredExponential(),
             gt.mean_functions.ConstantMean(),
             gt.noise_functions.GaussianNoise(constant_add=True))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        gt.GP(*parts)
    meta = {"D": 2, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0], "dtype": "float64"}
    with pytest.raises(RuntimeError, match="CUDA"):
        gp_from_arrays(meta, None, None, None, None)
    g = gt.GP(*parts, device="cpu")
    assert g.device == torch.device("cpu")
    g.save(tmp_path / "empty.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.GP.load(tmp_path / "empty.npz")
    assert gt.GP.load(tmp_path / "empty.npz", device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert gt.gp.resolve_device(None) == torch.device("cuda")
