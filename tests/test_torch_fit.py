"""``GP.fit`` of the port, MAP only, end to end against
``gpyreg_tpu.GP.fit`` on the CPU in float64 with the same numpy seed.

Tolerances: both packages build the same design (identical best design
row at 1e-12 on the split path); the MAP objective agrees to
1e-5 * max(1, |f|) (two different optimizers, both run to
``tol_opt = 1e-8`` so that what is compared is the optimum and not where
a 1e-5 stop rule left each of them); the posterior
``alpha`` at the port's own MAP equals the JAX posterior rebuilt at that
MAP to 1e-8 relative; with ``optimizer_backend="scipy"`` both sides run
the same L-BFGS-B on objectives that agree to 1e-8, so the
hyperparameters themselves agree to 1e-4.  Each JAX fit is compiled once,
in a module-scoped fixture."""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt

torch.set_num_threads(1)

N, D = 60, 2
BASE = {"n_samples": 0, "init_N": 48, "opts_N": 2, "tol_opt": 1e-8}
PRIORS = {
    "covariance_log_lengthscale": ("gaussian", (0.0, 1.5)),
    "covariance_log_outputscale": ("student_t", (0.0, 2.0, 4.0)),
    "noise_log_scale": ("smoothbox", (-5.0, -1.0, 0.5)),
    "mean_const": None,
}


def _data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))
    return X, y


def _make(m, priors=None, **kw):
    g = m.GP(D, m.covariance_functions.SquaredExponential(),
             m.mean_functions.ConstantMean(),
             m.noise_functions.GaussianNoise(constant_add=True), **kw)
    if priors is not None:
        g.set_priors(priors)
    return g


def _fit(m, options, priors=None, seed=1, **kw):
    X, y = _data()
    g = _make(m, priors, **kw)
    np.random.seed(seed)
    hyp, res, samp = g.fit(X, y, options=dict(options))
    return g, hyp, res, samp


CASES = {
    "fused": (dict(BASE), None),
    "fused_priors": (dict(BASE), PRIORS),
    "split": ({**BASE, "opts_N": 0}, None),
    "scipy": ({**BASE, "optimizer_backend": "scipy"}, None),
    "subset": ({**BASE, "design_subset": 24}, None),
    "rand": ({**BASE, "init_method": "rand", "opts_N": 1}, None),
}


@pytest.fixture(scope="module")
def jax_fits():
    return {k: _fit(gj, o, p) for k, (o, p) in CASES.items()}


@pytest.fixture(scope="module")
def torch_fits():
    return {k: _fit(gt, o, p, device="cpu") for k, (o, p) in CASES.items()}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _objective(g, hyp):
    return float(g._objective(np.asarray(hyp).reshape(-1)))


@pytest.mark.parametrize("case", ["fused", "fused_priors", "subset", "rand"])
def test_fit_reaches_the_jax_map(case, jax_fits, torch_fits):
    g_j, hyp_j, res_j, _ = jax_fits[case]
    g_t, hyp_t, res_t, samp_t = torch_fits[case]
    assert samp_t is None and hyp_t.shape == hyp_j.shape == (1, 5)
    scale = max(1.0, abs(res_j.fun))
    assert abs(res_t.fun - res_j.fun) < 1e-5 * scale
    # The reported value is the objective at the reported point, in both
    # packages' arithmetic.
    assert abs(_objective(g_t, hyp_t) - res_t.fun) < 1e-8 * scale
    assert abs(_objective(g_j, hyp_t) - res_t.fun) < 1e-8 * scale
    assert np.array_equal(res_t.x, hyp_t[0]) and res_t.success
    assert np.all(hyp_t >= g_t.lower_bounds) and np.all(hyp_t <= g_t.upper_bounds)
    # Both fits filled the NaN bounds with the same recommendations.
    assert _rel(g_t.lower_bounds, g_j.lower_bounds) < 1e-12
    assert _rel(g_t.upper_bounds, g_j.upper_bounds) < 1e-12
    assert g_t.no_prior is g_j.no_prior
    assert np.array_equal(g_t.hyper_priors["df"], g_j.hyper_priors["df"],
                          equal_nan=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_posterior_is_the_jax_posterior_at_the_same_map(case, jax_fits,
                                                            torch_fits):
    """The posterior the port stores after its fit, against the JAX
    posterior rebuilt at the port's own MAP: alpha to 1e-8 relative, and
    predictions from both."""
    g_j = jax_fits[case][0]
    g_t, hyp_t = torch_fits[case][:2]
    assert g_t.posteriors.size == 1
    assert np.array_equal(g_t.posteriors[0].hyp, hyp_t[0])
    X, y = _data()
    ref = _make(gj, CASES[case][1])
    ref.set_bounds(g_j.get_bounds())
    ref.update(X_new=X, y_new=y, hyp=hyp_t)
    alpha_t = g_t.posteriors[0].alpha.numpy()
    assert _rel(alpha_t, np.asarray(ref.posteriors[0].alpha)) < 1e-8
    xs = np.random.default_rng(5).uniform(-3, 3, (7, D))
    mu_t, s2_t = g_t.predict(xs)
    mu_j, s2_j = ref.predict(xs)
    assert np.max(np.abs(mu_t - mu_j)) < 1e-8
    assert np.max(np.abs(s2_t - s2_j)) < 1e-7


def test_split_path_takes_the_best_design_row(jax_fits, torch_fits):
    """``opts_N = 0``: no optimization, the answer is the best row of
    the design.  Equal rows at 1e-12 say that both packages drew the same
    design from the same seed and ranked it alike."""
    _, hyp_j, res_j, _ = jax_fits["split"]
    _, hyp_t, res_t, _ = torch_fits["split"]
    assert res_j is None and res_t is None
    assert np.max(np.abs(hyp_t - hyp_j)) <= 1e-12


def test_scipy_backend_gives_the_same_hyperparameters(jax_fits, torch_fits):
    _, hyp_j, res_j, _ = jax_fits["scipy"]
    _, hyp_t, res_t, _ = torch_fits["scipy"]
    assert np.max(np.abs(hyp_t - hyp_j)) < 1e-4
    assert abs(res_t.fun - res_j.fun) < 1e-5 * max(1.0, abs(res_j.fun))
    assert res_t.success and hasattr(res_t, "nfev")  # scipy's own result


def test_design_subset_ranks_differently_and_optimizes_on_all_rows(torch_fits):
    """A subset at least as large as the data is the full ranking."""
    _, hyp_full, res_full, _ = torch_fits["fused"]
    _, hyp_id, res_id, _ = _fit(gt, {**BASE, "design_subset": 10_000},
                                device="cpu")
    assert np.array_equal(hyp_id, hyp_full) and res_id.fun == res_full.fun
    g_s, hyp_s, res_s, _ = torch_fits["subset"]
    assert abs(_objective(g_s, hyp_s) - res_s.fun) < 1e-8 * max(1.0, abs(res_s.fun))


def test_fit_timings_and_restart_results(torch_fits):
    g, hyp, res, _ = torch_fits["fused"]
    assert sorted(g.fit_timings) == ["design_s", "optimize_s", "posterior_s"]
    assert all(v >= 0 for v in g.fit_timings.values())
    assert res.nit > 0 and res.stop in ("gradient", "objective_drop", "step")
    assert np.isfinite(res.grad_norm)


def test_fit_takes_hyp0_bounds_and_a_second_fit():
    """``hyp0`` as a dict, bounds as arrays through the options, and a
    second fit that starts from the first one's hyperparameters; all
    against the JAX package."""
    X, y = _data()
    opts = {"n_samples": 0, "init_N": 8, "opts_N": 1,
            "lower_bounds": np.array([-4.0, -4.0, -3.0, np.nan, np.nan]),
            "upper_bounds": np.array([2.0, 2.0, 3.0, 0.0, np.nan])}
    hyp0 = {"covariance_log_lengthscale": np.array([0.1, 0.2]),
            "covariance_log_outputscale": np.array([0.0]),
            "noise_log_scale": np.array([-2.0]),
            "mean_const": np.array([0.0])}
    out = []
    for m, kw in ((gj, {}), (gt, {"device": "cpu"})):
        g = _make(m, **kw)
        np.random.seed(4)
        hyp1, res1, _ = g.fit(X, y, hyp0=hyp0, options=dict(opts))
        np.random.seed(4)
        hyp2, res2, _ = g.fit(options={"n_samples": 0, "init_N": 4,
                                       "opts_N": 1})
        out.append((g, res1, res2))
    (g_j, r1_j, r2_j), (g_t, r1_t, r2_t) = out
    assert _rel(g_t.lower_bounds, g_j.lower_bounds) < 1e-12
    assert _rel(g_t.upper_bounds, g_j.upper_bounds) < 1e-12
    assert g_t.lower_bounds[0] == -4.0 and g_t.upper_bounds[3] == 0.0
    for r_t, r_j in ((r1_t, r1_j), (r2_t, r2_j)):
        assert abs(r_t.fun - r_j.fun) < 1e-5 * max(1.0, abs(r_j.fun))
    assert r2_t.fun <= r1_t.fun + 1e-6


def test_laplace_is_the_map_fit():
    _, hyp_a, res_a, samp = _fit(gt, {**BASE, "n_samples": 5,
                                      "sampler": "laplace", "init_N": 16},
                                 device="cpu")
    _, hyp_b, res_b, _ = _fit(gt, {**BASE, "init_N": 16}, device="cpu")
    assert samp is None and np.array_equal(hyp_a, hyp_b)


def test_float32_fit_on_the_cpu_respects_the_noise_floor():
    """A float32 GP fits through the plain versions of the kernels on
    the CPU; with the floor forced, the MAP noise stays above it."""
    X, y = _data()
    g = _make(gt, dtype=np.float32, device="cpu")
    np.random.seed(2)
    hyp, res, _ = g.fit(X, y, options={**BASE, "init_N": 16,
                                       "f32_noise_floor": -1.0})
    assert hyp[0, D + 1] >= -1.0 and np.isfinite(res.fun)
    assert g.lower_bounds[D + 1] < -1.0  # the GP's own bounds are untouched
    assert g.posteriors[0].alpha.dtype == torch.float32
    g64 = _make(gt, device="cpu")
    g64.X, g64.y = X, y
    g64.set_bounds(g.get_bounds())
    assert abs(_objective(g64, hyp) - res.fun) < 1e-3 * max(1.0, abs(res.fun))


# Options the port refuses, each raising before any state changes:
# trace_dir (a JAX profiler hook, not ported) and output warping with the
# matrix-free method, by option or on the GP (the JAX package's CG
# objective never warps y).
_WARP = gt.outwarp_functions.NegativePower
LEFT_OUT = {
    "cg": ({"n_samples": 0, "method": "cg", "outwarp_fun": _WARP()}, {},
           ValueError, "Output warping"),
    "auto_above_threshold": ({"n_samples": 0, "method": "auto",
                              "cg_threshold_n": 10, "outwarp_fun": _WARP()},
                             {}, ValueError, "Output warping"),
    "outwarp_fun": ({"n_samples": 0, "method": "cg"}, {"outwarp": _WARP()},
                    ValueError, "Output warping"),
    "trace_dir": ({"n_samples": 0, "trace_dir": "somewhere"}, {},
                  NotImplementedError, "profile"),
}


@pytest.mark.parametrize("case", sorted(LEFT_OUT))
def test_left_out_options_raise_and_change_nothing(case):
    options, kw, error, names = LEFT_OUT[case]
    X, y = _data()
    g = _make(gt, device="cpu", **kw)
    with pytest.raises(error, match=names):
        g.fit(X, y, options=options)
    assert g.X is None and g.posteriors is None
    assert not hasattr(g, "fit_timings")


def test_unknown_names_raise_value_errors():
    X, y = _data()
    g = _make(gt, device="cpu")
    with pytest.raises(ValueError, match="Unknown sampler"):
        g.fit(X, y, options={"n_samples": 3, "sampler": "gibbs"})
    with pytest.raises(ValueError, match="Unknown fit method"):
        g.fit(X, y, options={"n_samples": 0, "method": "sparse"})
    # "auto" below its threshold is the exact fit.
    np.random.seed(0)
    hyp, res, _ = g.fit(X, y, options={"n_samples": 0, "method": "auto",
                                       "init_N": 4, "opts_N": 1})
    assert np.isfinite(res.fun)


def test_fit_without_a_card_raises_on_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        _make(gt)
