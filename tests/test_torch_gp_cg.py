"""``GP.fit(options={"method": "cg"})`` and the matrix-free posteriors of
the port against ``gpyreg_tpu`` on the CPU in float64, with the JAX
package's probes and chain keys injected (``tests/torch_replay.py``).

Both fits start from the same numpy seed, so both rank the same design
with the same probes and start scipy's L-BFGS-B from the same row:
the hyperparameters agree to 1e-6 and every evaluation's CG iteration
count is equal.  The data take a noise sn = 3 and the bounds keep sn >= 1
and sf <= e, so that every solve converges before finite-precision CG
turns chaotic (see ``test_torch_iterative.py``).  Covered: ``method="cg"``
and ``"auto"`` with ``cg_threshold_n`` lowered; ``predict`` on the
matrix-free posteriors (1e-8 relative), with ``add_noise``, and against the
exact posterior; ``update`` with new rows; ``save``/``load`` across the
packages; the refusals of the calls that need factors; the fixed-probe
chain with the device and the host driver; and the refusal of output
warping with the CG method, beside the JAX package's zero warp gradient
that it guards against."""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt
from torch_replay import patch_probes, patch_streams

torch.set_num_threads(1)

N, D = 150, 2
RTOL = 1e-8
SIDES = (("jax", gj, {}), ("torch", gt, {"device": "cpu"}))
CG = {"method": "cg", "n_samples": 0, "cg_row_chunk": 64, "cg_tol": 1e-8,
      "cg_n_probes": 4, "cg_n_lanczos": 16, "cg_max_opt_iter": 4,
      "cg_init_N": 4, "cg_predict_tol": 1e-8, "cg_test_chunk": 16}


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, D))
    y = 3.0 * np.sin(np.sum(X, axis=1, keepdims=True)) + 3.0 * rng.normal(size=(n, 1))
    return X, y


def _bounds():
    lb, ub = np.full(D + 3, np.nan), np.full(D + 3, np.nan)
    lb[D + 1], ub[D] = 0.0, 1.0
    return {"lower_bounds": lb, "upper_bounds": ub}


def _make(m, warp=None, **kw):
    return m.GP(D, m.covariance_functions.SquaredExponential(),
                m.mean_functions.ConstantMean(),
                m.noise_functions.GaussianNoise(constant_add=True),
                **({} if warp is None else {"outwarp": warp}), **kw)


def _fit(m, kw, options, seed=1):
    X, y = _data()
    g = _make(m, **kw)
    np.random.seed(seed)
    out = g.fit(X, y, options={**options, **_bounds()})
    return g, out + (np.random.rand(),)


CASES = {
    "cg": CG,
    "auto": {**CG, "method": "auto", "cg_threshold_n": 100},
    "device_chain": {**CG, "n_samples": 2, "thin": 1, "burn": 4,
                     "cg_sample_tol": 1e-8, "cg_sample_driver": "device"},
    "host_chain": {**CG, "n_samples": 2, "thin": 1, "burn": 4,
                   "cg_sample_tol": 1e-8, "cg_sample_driver": "host"},
}


@pytest.fixture(scope="module")
def fits():
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_probes(mp)
        patch_streams(mp)
        for name, opts in CASES.items():
            for side, m, kw in SIDES:
                # "auto" picks CG here, so the JAX "cg" fit is its reference.
                if (name, side) != ("auto", "jax"):
                    out[name, side] = _fit(m, kw, opts)
    out["auto", "jax"] = out["cg", "jax"]
    return out


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0)


@pytest.mark.parametrize("name", ["cg", "auto"])
def test_cg_fit_matches_jax(name, fits):
    g_j, (hyp_j, res_j, sr_j, u_j) = fits[name, "jax"]
    g_t, (hyp_t, res_t, sr_t, u_t) = fits[name, "torch"]
    assert sr_t is None and sr_j is None and u_t == u_j
    assert g_t._infer_method == g_j._infer_method == "cg"
    assert _rel(hyp_t, hyp_j) < 1e-6
    assert abs(res_t.fun - res_j.fun) < RTOL * abs(res_j.fun)
    assert res_t.nfev == res_j.nfev
    assert np.array_equal(res_t.cg_iters, np.asarray(res_j.cg_iters))
    assert set(g_t.fit_timings) == {"design_s", "optimize_s", "sample_s",
                                    "posterior_s"}
    assert g_t._cg_options == g_j._cg_options
    p = g_t.posteriors[0]
    assert p.matrix_free and p.L is None and p.alpha is None and p.sn2_mult == 1


def _pair_at(fits, name="cg"):
    """Matrix-free GPs of both packages at the port's hyperparameters."""
    g_t = fits[name, "torch"][0]
    hyp = g_t.get_hyperparameters(as_array=True)
    out = []
    for side, m, kw in SIDES:
        g = _make(m, **kw)
        g.X, g.y = g_t.X, g_t.y
        g._infer_method, g._cg_options = "cg", dict(g_t._cg_options)
        g.update(hyp=hyp)
        out.append(g)
    return out


@pytest.mark.parametrize("add_noise", [False, True])
def test_matrix_free_predict_matches_jax_and_the_exact_posterior(fits, add_noise):
    g_j, g_t = _pair_at(fits)
    xs = np.random.default_rng(2).uniform(-3, 3, (40, D))
    mu_t, s2_t = g_t.predict(xs, add_noise=add_noise)
    mu_j, s2_j = g_j.predict(xs, add_noise=add_noise)
    assert _rel(mu_t, mu_j) < RTOL and _rel(s2_t, s2_j) < RTOL
    p = g_t.posteriors[0]
    assert p._alpha is not None and p._alpha.shape == (192, 1)
    assert _rel(p.alpha.numpy(), np.asarray(g_j.posteriors[0].alpha)) < RTOL
    again = g_t.predict(xs, add_noise=add_noise)
    assert np.array_equal(again[0], mu_t) and np.array_equal(again[1], s2_t)
    exact = _make(gt, device="cpu")
    exact.update(X_new=g_t.X, y_new=g_t.y, hyp=g_t.get_hyperparameters(as_array=True))
    mu_e, s2_e = exact.predict(xs, add_noise=add_noise)
    assert np.max(np.abs(mu_t - mu_e)) < 1e-6 and np.max(np.abs(s2_t - s2_e)) < 1e-6


def test_update_with_new_rows_matches_jax(fits):
    g_j, g_t = _pair_at(fits)
    X2, y2 = _data(n=20, seed=3)
    xs = X2[:8]
    for g in (g_j, g_t):
        g.predict(xs)  # caches alpha, which the update must drop
        g.update(X_new=X2, y_new=y2)
        assert g.X.shape[0] == N + 20 and g.posteriors[0].matrix_free
        assert g.posteriors[0]._alpha is None
    a, b = g_t.predict(xs), g_j.predict(xs)
    assert _rel(a[0], b[0]) < RTOL and _rel(a[1], b[1]) < RTOL
    # One new row takes no rank-1 path: the posteriors stay matrix-free.
    g_t.update(X_new=X2[:1] + 0.1, y_new=y2[:1])
    assert g_t.posteriors[0].matrix_free and g_t.X.shape[0] == N + 21


def test_save_load_round_trip_across_the_packages(fits, tmp_path):
    g_j, g_t = _pair_at(fits)
    xs = np.random.default_rng(4).uniform(-3, 3, (12, D))
    mu_t, s2_t = g_t.predict(xs)
    g_j.save(tmp_path / "jax.npz")
    g_t.save(tmp_path / "port.npz")
    from_jax = gt.GP.load(tmp_path / "jax.npz", device="cpu")
    assert from_jax._infer_method == "cg" and from_jax.posteriors[0].matrix_free
    a, b = from_jax.predict(xs), gj.GP.load(tmp_path / "jax.npz").predict(xs)
    assert _rel(a[0], b[0]) < RTOL and _rel(a[1], b[1]) < RTOL
    # The port's file keeps the serving options: the reloaded GP predicts
    # exactly as the saved one did; the JAX package reads it too.
    mine = gt.GP.load(tmp_path / "port.npz", device="cpu")
    assert mine._cg_options == g_t._cg_options
    c = mine.predict(xs)
    assert np.array_equal(c[0], mu_t) and np.array_equal(c[1], s2_t)
    back = gj.GP.load(tmp_path / "port.npz")
    assert back._infer_method == "cg" and back.posteriors[0].matrix_free


def test_calls_that_need_factors_refuse_matrix_free_posteriors(fits):
    g_t = _pair_at(fits)[1]
    for call in (lambda: g_t.quad(np.zeros((1, D)), np.ones((1, D))),
                 lambda: g_t.predict_full(np.zeros((3, D))),
                 lambda: g_t.random_function(np.zeros((3, D))),
                 lambda: g_t.fmin(),
                 lambda: g_t.sample(5)):
        with pytest.raises(ValueError, match="matrix-free"):
            call()


@pytest.mark.parametrize("name", ["device_chain", "host_chain"])
def test_fixed_probe_chain_equals_the_jax_chain(name, fits):
    g_j, (hyp_j, _, sr_j, u_j) = fits[name, "jax"]
    g_t, (hyp_t, _, sr_t, u_t) = fits[name, "torch"]
    assert hyp_t.shape == hyp_j.shape == (2, D + 3) and u_t == u_j
    for k in ("samples", "f_vals", "log_priors"):
        assert _rel(sr_t[k], sr_j[k]) < RTOL, k
    assert sr_t["exit_flag"] == sr_j["exit_flag"]
    assert all(p.matrix_free for p in g_t.posteriors)
    xs = np.random.default_rng(5).uniform(-3, 3, (6, D))
    a, b = g_t.predict(xs), g_j.predict(xs)
    assert _rel(a[0], b[0]) < RTOL and _rel(a[1], b[1]) < RTOL


def test_cg_without_explicit_n_samples_warns_and_runs_map():
    X, y = _data(n=64)
    g = _make(gt, device="cpu")
    opts = {k: v for k, v in CG.items() if k != "n_samples"}
    with pytest.warns(UserWarning, match="explicit request"):
        hyp, _, sr = g.fit(X, y, options={**opts, "cg_max_opt_iter": 2,
                                          **_bounds()})
    assert sr is None and hyp.shape == (1, D + 3)


@pytest.mark.parametrize("how", ["cg", "auto_picks_cg", "outwarp_fun"])
def test_output_warping_with_cg_raises_before_any_state_changes(how):
    """The port refuses what the JAX package gets wrong: JAX's CG
    objective never warps y (gpyreg_tpu/ops/iterative.py:435-444), so
    the warp hyperparameters' gradient is exactly 0 and L-BFGS leaves
    them where the design put them, while predict back-transforms through
    the warp (gpyreg_tpu/gp.py:2240-2259)."""
    X, y = _data(n=64)
    opts = {**CG, "cg_max_opt_iter": 2, **_bounds()}
    warp = gt.outwarp_functions.NegativePowerC1()
    if how == "auto_picks_cg":
        opts = {**opts, "method": "auto", "cg_threshold_n": 10}
    if how == "outwarp_fun":
        g = _make(gt, device="cpu")
        opts = {**opts, "outwarp_fun": warp}
    else:
        g = _make(gt, warp=warp, device="cpu")
    hyp_N, bounds = g._hyp_N(), g.lower_bounds.copy()
    with pytest.raises(ValueError, match="Output warping"):
        g.fit(X, y, options=opts)
    assert g.X is None and g.y is None and g.posteriors is None
    assert g._hyp_N() == hyp_N and np.array_equal(g.lower_bounds, bounds,
                                                  equal_nan=True)
    assert g._infer_method == "exact"


def test_jax_cg_fit_leaves_the_warp_hyperparameters_unmoved():
    """The divergence the refusal above guards against, shown on the JAX
    package: a warped CG fit ends with gradient entries of exactly 0 for
    both warp hyperparameters."""
    X, y = _data(n=64)
    y = -0.5 * np.sum(X**2, axis=1, keepdims=True)
    lb, ub = np.full(D + 5, np.nan), np.full(D + 5, np.nan)
    lb[D + 1], ub[D] = 0.0, 1.0
    g = _make(gj, warp=gj.outwarp_functions.NegativePowerC1())
    np.random.seed(0)
    hyp, res, _ = g.fit(X, y, options={**CG, "cg_max_opt_iter": 3,
                                       "lower_bounds": lb, "upper_bounds": ub})
    assert hyp.shape == (1, D + 5)
    assert np.all(res.jac[-2:] == 0.0) and np.any(res.jac[:-2] != 0.0)
