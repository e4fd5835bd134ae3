"""The serving slice as a whole: a JAX ``GP`` with S=3 hyperparameter
samples is saved, the port loads the ``.npz``, and the ``Posterior``
fields and ``predict`` are compared, in float64 on the CPU.

Parametrizations: Cholesky (noise above 1e-6), explicit inverse (below),
mixed (rows straddling 1e-6) and ``fast_predict``.  Tolerances follow
the verify skill (.claude/skills/verify/SKILL.md): predictive mean 1e-10
absolute, variance 1e-7 absolute; stored factors 1e-8 relative.
"""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
from gpyreg_tpu.ops import pallas_kernels as PK
import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch import gp as gp_mod
from gpyreg_tpu_torch.convert import gp_from_arrays
from gpyreg_tpu_torch.ops import tile_kernels as TK

torch.set_num_threads(1)

MU_TOL, S2_TOL, FACTOR_RTOL = 1e-10, 1e-7, 1e-8

# name -> (noise log-scales of the 3 samples, fast_predict, mean, user s2)
CASES = {
    "chol": ((-2.0, -2.1, -1.9), False, "const", False),
    "inv": ((-8.0, -8.2, -7.9), False, "const", False),
    "mixed": ((-2.0, -9.0, -2.3), False, "const", False),
    "fast_predict": ((-2.0, -2.1, -1.9), True, "const", False),
    "negquad_user_s2": ((-2.0, -2.5, -2.2), False, "negquad", True),
}


def _jax_gp(name, tmp_path, N=50, D=2, seed=0):
    log_sn, fast, mean, user = CASES[name]
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))
    s2 = rng.uniform(0.01, 0.04, (N, 1)) if user else None
    mean_obj = {"const": gj.mean_functions.ConstantMean,
                "negquad": gj.mean_functions.NegativeQuadratic}[mean]()
    g = gj.GP(
        D, gj.covariance_functions.SquaredExponential(), mean_obj,
        gj.noise_functions.GaussianNoise(constant_add=True,
                                          user_provided_add=user),
        fast_predict=fast,
    )
    hyp = 0.1 * rng.normal(size=(3, g._hyp_N()))
    hyp[:, D + 1] = log_sn
    g.update(X_new=X, y_new=y, s2_new=s2, hyp=hyp, compute_posterior=True)
    path = tmp_path / f"{name}.npz"
    g.save(path)
    return g, gt.GP.load(path, device="cpu"), rng


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loaded_posteriors_match_jax(name, tmp_path):
    g, p, _ = _jax_gp(name, tmp_path)
    assert p.posteriors.size == 3
    for pj, pt in zip(g.posteriors, p.posteriors):
        assert pt.L_chol == pj.L_chol and pt.sn2_mult == pj.sn2_mult
        assert np.array_equal(pt.hyp, pj.hyp)
        for field in ("alpha", "sW", "L"):
            assert _rel(getattr(pt, field).numpy(),
                        getattr(pj, field)) < FACTOR_RTOL, field
    expect = {"chol": [True] * 3, "inv": [False] * 3,
              "mixed": [True, False, True], "fast_predict": [False] * 3}
    if name in expect:
        assert [pt.L_chol for pt in p.posteriors] == expect[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_predict_matches_jax(name, tmp_path):
    g, p, rng = _jax_gp(name, tmp_path)
    xs = rng.uniform(-3, 3, (40, 2))
    ys = np.sin(np.sum(xs, axis=1, keepdims=True))
    s2s = np.full((40, 1), 0.02) if CASES[name][3] else None
    for kw in (
        {},
        {"separate_samples": True},
        {"add_noise": True},
        {"add_noise": True, "separate_samples": True},
        {"return_lpd": True},
        {"return_lpd": True, "separate_samples": True},
    ):
        out_j = g.predict(xs, y_star=ys, s2_star=s2s, **kw)
        out_t = p.predict(xs, y_star=ys, s2_star=s2s, **kw)
        assert len(out_t) == len(out_j)
        assert out_t[0].shape == out_j[0].shape
        assert np.max(np.abs(out_t[0] - out_j[0])) < MU_TOL, kw
        assert np.max(np.abs(out_t[1] - out_j[1])) < S2_TOL, kw
        if len(out_t) == 3:
            # lpd divides by the predictive variance, which is ~1e-7 for
            # the low-noise samples: it carries the variance's 1e-7
            # absolute tolerance as ~1e-5 relative.
            lpd_t, lpd_j = out_t[2], out_j[2]
            assert np.max(np.abs(lpd_t - lpd_j)) < 1e-5 * max(
                1.0, np.max(np.abs(lpd_j))
            ), kw


def test_chunked_predict_and_prior_predict(tmp_path, monkeypatch):
    g, p, rng = _jax_gp("mixed", tmp_path)
    xs = rng.uniform(-3, 3, (333, 2))
    mu_full, s2_full = p.predict(xs, separate_samples=True)
    # 2 chunks of 128 points and a ragged one of 77.
    monkeypatch.setattr(gp_mod, "_PREDICT_CHUNK_ELEMS", 128 * 50)
    mu_c, s2_c = p.predict(xs, separate_samples=True)
    assert np.max(np.abs(mu_c - mu_full)) < 1e-12
    assert np.max(np.abs(s2_c - s2_full)) < 1e-12

    # No data: the prior branch.
    hyp = g.get_hyperparameters(as_array=True)
    gj0 = gj.GP(2, gj.covariance_functions.SquaredExponential(),
                gj.mean_functions.ConstantMean(),
                gj.noise_functions.GaussianNoise(constant_add=True))
    gj0.update(hyp=hyp, compute_posterior=False)
    gt0 = gt.GP(2, gt.covariance_functions.SquaredExponential(),
                gt.mean_functions.ConstantMean(),
                gt.noise_functions.GaussianNoise(constant_add=True),
                device="cpu")
    gt0.update(hyp=hyp, compute_posterior=False)
    for a, b in zip(gt0.predict(xs[:10], separate_samples=True),
                    gj0.predict(xs[:10], separate_samples=True)):
        assert np.max(np.abs(a - b)) < 1e-12


def test_port_save_roundtrips_through_both_packages(tmp_path):
    g, p, rng = _jax_gp("negquad_user_s2", tmp_path)
    path = tmp_path / "port.npz"
    p.save(path)
    back_j = gj.GP.load(path)
    back_t = gt.GP.load(path, device="cpu")
    xs = rng.uniform(-3, 3, (20, 2))
    mu_j, s2_j = back_j.predict(xs)
    mu_t, s2_t = back_t.predict(xs)
    assert np.max(np.abs(mu_t - mu_j)) < MU_TOL
    assert np.max(np.abs(s2_t - s2_j)) < S2_TOL
    assert np.array_equal(back_t.lower_bounds, g.lower_bounds, equal_nan=True)
    assert p.get_hyperparameters()[0].keys() == g.get_hyperparameters()[0].keys()

    # Saved without factors: load keeps the hyperparameters only.
    g.clean()
    g.save(tmp_path / "clean.npz")
    empty = gt.GP.load(tmp_path / "clean.npz", device="cpu")
    assert empty.posteriors[0].alpha is None
    assert np.array_equal(empty.get_hyperparameters(as_array=True),
                          g.get_hyperparameters(as_array=True))


def test_float32_slice_with_kernel_tile_matches_jax_pallas(monkeypatch):
    """The float32 slice with ``pallas_predict``: JAX's Pallas kernel in
    interpret mode against the port's plain composition on the CPU (the
    kernel tile's plain version), built from the same arrays.  float32
    tolerance: the factors of G (condition ~1e3 here) lose ~1e-4
    relative."""
    monkeypatch.setattr(PK, "INTERPRET", True)
    rng = np.random.default_rng(3)
    N, D = 300, 3
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    hyp = 0.05 * rng.normal(size=(2, D + 3))
    hyp[:, D + 1] += np.log(0.1)
    g = gj.GP(D, gj.covariance_functions.SquaredExponential(),
              gj.mean_functions.ConstantMean(),
              gj.noise_functions.GaussianNoise(constant_add=True),
              dtype=np.float32, pallas_predict=True)
    g.update(X_new=X, y_new=y, hyp=hyp)
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0], "dtype": "float32",
            "pallas_predict": 1}
    p = gp_from_arrays(meta, X, y, None, hyp, device="cpu")
    assert p.posteriors[0].alpha.dtype == torch.float32
    xs = rng.normal(size=(400, D))
    TK.reset_launches()
    mu_j, s2_j = g.predict(xs, separate_samples=True)
    mu_t, s2_t = p.predict(xs, separate_samples=True)
    assert set(TK.LAUNCHES.values()) == {0}  # CPU: plain
    assert np.max(np.abs(mu_t - mu_j)) < 1e-3
    assert np.max(np.abs(s2_t - s2_j)) < 1e-3


def test_scaled_user_noise_survives_load(tmp_path):
    """A saved GP with scaled user noise (parameters[1] == 2) loads into
    the port with that feature, and serves what the saved GP served.
    Divergence recorded: gpyreg_tpu's own GP.load (gp.py:2594-2599)
    rebuilds it with user_provided_add=(p[1] == 1), dropping the feature
    and one hyperparameter."""
    rng = np.random.default_rng(6)
    N, D = 40, 2
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True))
    s2 = rng.uniform(0.01, 0.04, (N, 1))
    noise = gj.noise_functions.GaussianNoise(
        constant_add=True, user_provided_add=True, scale_user_provided=True
    )
    g = gj.GP(D, gj.covariance_functions.SquaredExponential(),
              gj.mean_functions.ConstantMean(), noise)
    hyp = 0.1 * rng.normal(size=(2, g._hyp_N()))
    hyp[:, D + 1] = -2.0
    g.update(X_new=X, y_new=y, s2_new=s2, hyp=hyp)
    g.save(tmp_path / "scaled.npz")
    p = gt.GP.load(tmp_path / "scaled.npz", device="cpu")
    assert np.array_equal(p.noise.parameters, g.noise.parameters)
    assert gj.GP.load(tmp_path / "scaled.npz").noise.parameters[1] == 0
    xs = rng.uniform(-3, 3, (30, D))
    for a, b in zip(p.predict(xs), g.predict(xs)):
        assert np.max(np.abs(a - b)) < MU_TOL
