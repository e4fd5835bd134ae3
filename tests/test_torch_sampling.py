"""``GP.fit`` with hyperposterior sampling, the port against
``gpyreg_tpu.GP.fit`` on the CPU in float64.

Both fits start from the same numpy seed with ``opts_N = 0``, so both
take the best row of the same design as the chain's start, with the same
widths (the design's spread).  Under the replay of the JAX key tree
(``tests/torch_replay.py``; the port seeds its stream with the integer
the JAX package builds its key from) the chains are the same chain: the
samples, ``f_vals``, ``log_priors``, R and eff_N agree to 1e-8
relative, the exit flags are equal, numpy's global stream is left in the
same state, and ``predict`` afterwards agrees to 1e-10 (mean) and 1e-7
(variance).  Covered: slicesample, covsample, two chains with
``chain_thin`` 2, the host backend (numpy's stream, no replay), the
gradient samplers mala (thin and burn-in scaled by the number of
hyperparameters) and hmc, the ensemble sampler eissample, and
slicelite twice (the warm-refit shortcut, explicit ``hyp0_logp``, the
``log_P`` alias, a low ESS falling back to the full pipeline, a length
mismatch raising).  Each JAX fit runs once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt
from torch_replay import patch_streams

torch.set_num_threads(1)

N, D = 48, 2
RTOL = 1e-8
BASE = {"n_samples": 6, "thin": 2, "burn": 8, "init_N": 32, "opts_N": 0}
LITE = {**BASE, "sampler": "slicelite"}
CASES = {
    "slicesample": {},
    "covsample": {"sampler": "covsample"},
    "chains": {"n_chains": 2, "chain_thin": 2},
    "host": {"sampler_backend": "host"},
    "mala": {"sampler": "mala"},
    "hmc": {"sampler": "hmc"},
    "eissample": {"sampler": "eissample"},
}
SIDES = (("jax", gj, {}), ("torch", gt, {"device": "cpu"}))


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.3 * rng.normal(size=(n, 1))
    return X, y


def _make(m, **kw):
    return m.GP(D, m.covariance_functions.SquaredExponential(),
                m.mean_functions.ConstantMean(),
                m.noise_functions.GaussianNoise(constant_add=True), **kw)


def _fit(g, X, y, options, seed=1, hyp0=None):
    """(hyp, optimize_result, sampling_result, the next uniform of numpy's
    global stream after the fit)."""
    np.random.seed(seed)
    out = g.fit(X, y, hyp0=hyp0, options=dict(options))
    return out + (np.random.rand(),)


def _lite_runs(m, kw):
    """The slicelite scenarios of one package."""
    X, y = _data()
    g = _make(m, **kw)
    first = _fit(g, X, y, LITE)
    hyp1, logp1 = first[0], g._warm_logp.copy()
    # A few more rows of the same function: the posterior barely moves.
    X2, y2 = _data(N + 2)
    # The first fit's record, before the refit replaces it.
    record = {"timings": dict(g.fit_timings), "warm_hyp": g._warm_hyp.copy(),
              "warm_logp": logp1}
    out = {"first": (record, first), "shortcut": (g, _fit(g, X2, y2, LITE, seed=2))}
    for name, key in (("hyp0_logp", "hyp0_logp"), ("log_P", "log_P")):
        g2 = _make(m, **kw)
        out[name] = (g2, _fit(g2, X, y, {**LITE, key: logp1}, seed=3, hyp0=hyp1))
    # New data wholesale: the old samples cover it poorly.
    g3 = _make(m, **kw)
    _fit(g3, X, y, LITE)
    y3 = 5.0 * np.cos(2.0 * X[:, :1] * X[:, 1:])
    out["low_ess"] = (g3, _fit(g3, X, y3, LITE, seed=4))
    with pytest.raises(ValueError, match="hyp0_logp") as e:
        _fit(_make(m, **kw), X, y, {**LITE, "hyp0_logp": np.zeros(3)}, hyp0=hyp1)
    out["mismatch"] = str(e.value)
    return out


@pytest.fixture(scope="module")
def fits():
    X, y = _data()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        patch_streams(mp)
        for name, opts in CASES.items():
            for side, m, kw in SIDES:
                g = _make(m, **kw)
                out[name, side] = (g, _fit(g, X, y, {**BASE, **opts}))
        for side, m, kw in SIDES:
            out["lite", side] = _lite_runs(m, kw)
    return out


def _close(a, b, what, rtol=RTOL):
    if b is None:
        assert a is None, what
        return
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, what
    assert np.max(np.abs(a - b), initial=0.0) <= rtol * max(
        1.0, np.max(np.abs(b), initial=0.0)), what


def _same_fit(t, j):
    (g_t, (hyp_t, res_t, sr_t, u_t)), (g_j, (hyp_j, res_j, sr_j, u_j)) = t, j
    _close(hyp_t, hyp_j, "hyp")
    for k in ("samples", "f_vals", "log_priors", "R", "eff_N"):
        _close(sr_t[k], sr_j[k], k)
    assert sr_t["exit_flag"] == sr_j["exit_flag"]
    assert u_t == u_j
    assert (res_t is None) == (res_j is None)
    xs = np.random.default_rng(5).uniform(-3, 3, (7, D))
    mu_t, s2_t = g_t.predict(xs)
    mu_j, s2_j = g_j.predict(xs)
    assert np.max(np.abs(mu_t - mu_j)) < 1e-10
    assert np.max(np.abs(s2_t - s2_j)) < 1e-7
    return g_t, hyp_t, sr_t


@pytest.mark.parametrize("name", sorted(CASES))
def test_fit_samples_equal_the_jax_samples(name, fits):
    g, hyp, sr = _same_fit(fits[name, "torch"], fits[name, "jax"])
    # MALA scales thin by the number of hyperparameters.
    thin = BASE["thin"] * (D + 3 if name == "mala" else 1)
    assert sr["samples"].shape == (BASE["n_samples"] * thin, D + 3)
    assert hyp.shape == (BASE["n_samples"], D + 3)
    assert np.array_equal(hyp, sr["samples"][thin - 1 :: thin])
    assert np.all(hyp >= g.lower_bounds) and np.all(hyp <= g.upper_bounds)
    assert g.posteriors.size == BASE["n_samples"]
    assert np.array_equal(g.get_hyperparameters(as_array=True), hyp)
    assert sorted(g.fit_timings) == ["design_s", "optimize_s", "posterior_s", "sample_s"]
    assert all(v >= 0 for v in g.fit_timings.values())
    # The warm state of the next slicelite refit.
    assert np.array_equal(g._warm_hyp, hyp) and g._warm_logp.shape == (len(hyp),)


def test_n_evals_travels_in_the_result(fits):
    """The count of density calls is a key of the result (per chain for
    chains), where the JAX package returns None at this size and passes
    its chains' count as a function attribute."""
    sweeps = BASE["burn"] + BASE["n_samples"] * BASE["thin"]
    free = D + 3
    n = fits["slicesample", "torch"][1][2]["n_evals"]
    assert isinstance(n, int) and n > sweeps * free
    assert fits["slicesample", "torch"][1][2]["n_sweeps"] == sweeps
    assert fits["slicesample", "jax"][1][2]["n_evals"] is None
    chains = fits["chains", "torch"][1][2]
    assert chains["n_chains"] == 2 and chains["n_evals"].shape == (2,)
    assert chains["n_sweeps"].shape == (2,) and np.all(chains["n_sweeps"] > 0)
    assert fits["covsample", "torch"][1][2]["n_evals"] > sweeps
    assert fits["host", "torch"][1][2]["n_evals"] > sweeps * free


def test_slicelite_first_fit_runs_the_full_pipeline(fits):
    (rec_t, (hyp_t, _, sr_t, u_t)), (rec_j, (hyp_j, _, sr_j, u_j)) = (
        fits["lite", "torch"]["first"], fits["lite", "jax"]["first"])
    _close(hyp_t, hyp_j, "hyp")
    _close(sr_t["f_vals"], sr_j["f_vals"], "f_vals")
    assert u_t == u_j
    # opts_N is 0, so the MAP's result is None on either path; the design
    # ran.
    assert rec_t["timings"]["design_s"] > 0 and "ess_frac" not in sr_t
    assert np.array_equal(rec_t["warm_hyp"], hyp_t)
    _close(rec_t["warm_logp"], rec_j["warm_logp"], "warm logp")


@pytest.mark.parametrize("name", ["shortcut", "hyp0_logp", "log_P"])
def test_slicelite_warm_refit_equals_the_jax_refit(name, fits):
    t, j = fits["lite", "torch"][name], fits["lite", "jax"][name]
    g, hyp, sr = _same_fit(t, j)
    assert t[1][1] is None and g.fit_report["restarts"] == []  # no MAP
    assert sr["ess_frac"] > 0.5
    _close(sr["ess_frac"], j[1][2]["ess_frac"], "ess_frac")
    assert sr["thin_eff"] == j[1][2]["thin_eff"] >= 1
    assert hyp.shape == (BASE["n_samples"], D + 3)
    assert g.fit_timings["design_s"] == 0.0 and g.fit_timings["sample_s"] >= 0
    assert sr["n_evals"].shape == (BASE["n_samples"],)
    assert np.array_equal(sr["n_sweeps"], [sr["thin_eff"]] * BASE["n_samples"])


def test_slicelite_low_ess_falls_back_to_the_full_pipeline(fits):
    t, j = fits["lite", "torch"]["low_ess"], fits["lite", "jax"]["low_ess"]
    g, _, sr = _same_fit(t, j)
    assert g.fit_timings["design_s"] > 0 and "ess_frac" not in sr
    assert g.slicelite_ess_frac <= 0.5
    _close(g.slicelite_ess_frac, j[0].slicelite_ess_frac, "ess_frac")


def test_slicelite_length_mismatch_raises_as_jax(fits):
    assert fits["lite", "torch"]["mismatch"] == fits["lite", "jax"]["mismatch"]


def test_host_backend_honours_sample_width_base():
    """A fault the port does not copy: the JAX package's host backend
    drops ``sample_width_base`` (``gpyreg_tpu/inference/sampling.py:519-
    524``), so its chain is the same with False as with True; the port's
    chain changes, since the end-of-burn width floor goes."""
    X, y = _data()
    opts = {**BASE, "sampler_backend": "host"}
    out = {}
    for side, m, kw in SIDES:
        for wb in (True, False):
            out[side, wb] = _fit(_make(m, **kw), X, y, {**opts, "sample_width_base": wb})[0]
    assert np.array_equal(out["jax", True], out["jax", False])
    _close(out["torch", True], out["jax", True], "width_base True")
    assert not np.allclose(out["torch", False], out["torch", True])


def test_later_samplers_raise_before_releasing_the_factors():
    """``fit`` refuses an unknown sampler name before it releases the
    previous posterior factors or changes any other state (the JAX
    package refuses it after the MAP)."""
    X, y = _data()
    g = _make(gt, device="cpu")
    _fit(g, X, y, {"n_samples": 0, "init_N": 8, "opts_N": 1})
    hyp, timings = g.get_hyperparameters(as_array=True), dict(g.fit_timings)
    for name in ("gibbs", "nuts", "Mala"):
        with pytest.raises(ValueError, match="Unknown sampler"):
            g.fit(X[:-1], y[:-1], options={"sampler": name, "n_samples": 2})
        assert g.posteriors[0].alpha is not None and g.X.shape == X.shape
        assert np.array_equal(g.get_hyperparameters(as_array=True), hyp)
        assert g.fit_timings == timings


def test_default_fit_samples_ten_hyperparameter_vectors():
    """``fit`` with its own defaults: slicesample, 10 samples thinned 5
    from 50 after a burn-in of 50, from a MAP at ``tol_opt_mcmc``."""
    X, y = _data()
    g = _make(gt, device="cpu")
    hyp, res, sr = _fit(g, X, y, {})[:3]
    assert hyp.shape == (10, D + 3) and sr["samples"].shape == (50, D + 3)
    assert res is not None and np.isfinite(res.fun)
    assert sr["exit_flag"] in (1, -1, -2, -3) and sr["R"].shape == (D + 3,)
    assert g.posteriors.size == 10


def test_float32_chain_values_are_the_recomputed_log_posterior():
    """A float32 fit samples in law only (a flipped accept test sends the
    chains apart); each kept sample's f_vals + log_priors is its float32
    log posterior recomputed, within 1e-5 relative."""
    X, y = _data()
    g = _make(gt, dtype=np.float32, device="cpu")
    g.set_priors({"covariance_log_lengthscale": ("gaussian", (0.0, 2.0)),
                  "covariance_log_outputscale": None,
                  "noise_log_scale": ("gaussian", (-1.0, 1.0)), "mean_const": None})
    hyp, _, sr = _fit(g, X, y, BASE)[:3]
    fns, args = g._obj_args()
    total = sr["f_vals"][:, 0] + sr["log_priors"]
    for s, v in zip(sr["samples"], total):
        ref = float(fns["log_post_chain_raw"](s, *args))
        assert abs(v - ref) <= 1e-5 * max(1.0, abs(ref))
    assert g.posteriors[0].alpha.dtype == torch.float32
