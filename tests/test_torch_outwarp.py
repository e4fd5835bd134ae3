"""Output warping in the port against ``gpyreg_tpu`` on the CPU in
float64, at 1e-8 relative unless a case says otherwise.

Covered: every warp's value, slope, inverse and bounds info; the NLML
and its gradient through ``core.nlml`` with a warp, plain and padded,
with and without user noise ``s2``; a MAP ``fit`` with ``outwarp_fun``
on the scipy backend (both sides run the same L-BFGS-B, so the
hyperparameters agree to 1e-4 and the objective to 1e-5 of scale, as in
``test_torch_fit.py``); ``predict`` with ``return_lpd``,
``add_noise`` and ``separate_samples`` and ``predict_quantile`` at the
MAP with a moderate noise; the refusals of ``predict_full`` and ``quad``; the rank-1 rule
(a warped GP rebuilds); a ``.npz`` saved by the JAX package loaded by
the port; and a slice-sampled warped fit under the replay of the JAX key
tree (``tests/torch_replay.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt
from gpyreg_tpu.core import model as MJ
from gpyreg_tpu.core import nlml as NJ
from gpyreg_tpu_torch.core import model as MT
from gpyreg_tpu_torch.core import nlml as NT
from torch_replay import patch_streams

torch.set_num_threads(1)

RTOL = 1e-8
N, D = 40, 2
WARPS = ("NegativePower", "NegativePowerC1", "NegativeScaledPower")
KINDS = {"NegativePower": "negpow", "NegativePowerC1": "negpowc1",
         "NegativeScaledPower": "negscaledpow"}


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0)


def _data(n=N, seed=0):
    """A log density with a heavy lower tail: the warp's threshold falls
    inside the data."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, D))
    y = -0.5 * np.sum(X**2, axis=1, keepdims=True) + 0.05 * rng.normal(size=(n, 1))
    return X, y


def _warp_hyp(kind):
    return {"negpow": [-2.0, np.log(0.7)], "negpowc1": [-1.5, np.log(0.5)],
            "negscaledpow": [-2.5, np.log(1.3), np.log(0.6)]}[kind]


@pytest.mark.parametrize("warp", WARPS)
def test_warp_value_slope_inverse_and_bounds(warp):
    wj, wt = getattr(gj.outwarp_functions, warp)(), getattr(gt.outwarp_functions, warp)()
    kind = KINDS[warp]
    assert wt._kind == wj._kind == kind
    assert wt.hyperparameter_count() == wj.hyperparameter_count()
    assert wt.hyperparameter_info() == wj.hyperparameter_info()
    hyp = np.asarray(_warp_hyp(kind))
    y = np.linspace(-9.0, 2.0, 57)[:, None]
    for a, b in zip(wt.compute(hyp, y, compute_grad=True),
                    wj.compute(hyp, y, compute_grad=True)):
        assert _rel(a, b) < 1e-12
    assert _rel(wt.compute(hyp, y), wj.compute(hyp, y)) < 1e-12
    assert _rel(wt.compute(hyp, y, inverse=True),
                wj.compute(hyp, y, inverse=True)) < 1e-12
    assert _rel(wt.compute(hyp, wt.compute(hyp, y), inverse=True), y) < 1e-12
    X, yd = _data()
    bt, bj = wt.get_bounds_info(X, yd), wj.get_bounds_info(X, yd)
    for k in ("LB", "UB", "PLB", "PUB", "x0"):
        assert np.array_equal(bt[k], bj[k]), k
    with pytest.raises(ValueError, match="only one function output"):
        wt.compute(hyp, y, inverse=True, compute_grad=True)
    # The masked delta keeps the gradient finite on the identity branch.
    h = torch.tensor(hyp, requires_grad=True)
    g, dt = gt.outwarp_functions.warp_value_and_dt(kind, h, torch.tensor(y))
    (grad,) = torch.autograd.grad(torch.sum(g) + torch.sum(torch.log(dt)), h)
    assert torch.all(torch.isfinite(grad))


def _spec_pair(kind, user_noise):
    kw = dict(D=D, cov="se", mean="const", noise_constant=True,
              noise_user=int(user_noise), noise_rectified=False, outwarp=kind)
    return MT.ModelSpec(**kw), MJ.ModelSpec(**kw)


def _nlz_problem(kind, user_noise, padded, S=3):
    spec_t, spec_j = _spec_pair(kind, user_noise)
    assert spec_t.hyp_N == spec_j.hyp_N
    X, y = _data()
    rng = np.random.default_rng(1)
    s2 = rng.uniform(0.01, 0.05, size=(N, 1)) if user_noise else None
    hyp = 0.2 * rng.normal(size=(S, spec_t.hyp_N))
    hyp[:, D + 1] = np.log(0.1)
    hyp[:, spec_t.hyp_N - len(_warp_hyp(kind)):] += np.asarray(_warp_hyp(kind))
    n_real = None
    if padded:
        pad = 5
        X = np.concatenate([X, np.repeat(X[-1:], pad, axis=0)])
        y = np.concatenate([y, np.zeros((pad, 1))])
        if s2 is not None:
            s2 = np.concatenate([s2, np.ones((pad, 1))])
        n_real = N
    return spec_t, spec_j, X, y, s2, hyp, n_real


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "padded"])
@pytest.mark.parametrize("user_noise", [False, True], ids=["no_s2", "s2"])
@pytest.mark.parametrize("kind", sorted(KINDS.values()))
def test_nlz_and_gradient_with_warping_match_jax(kind, user_noise, padded):
    spec_t, spec_j, X, y, s2, hyp, n_real = _nlz_problem(kind, user_noise, padded)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    n_j = None if n_real is None else jnp.asarray(n_real)
    fns = NT.get_fns(spec_t, user_noise, False, padded=padded)
    args = [t(X), t(y)] + ([t(s2)] if user_noise else []) + (
        [n_real] if padded else [])
    v_t, g_t = fns["nlz_grad"](hyp, *args)
    chain_t = NT.nlz_chain(spec_t, hyp, t(X), t(y), t(s2), n_real)
    design_t = NT.nlz_design(spec_t, hyp, t(X), t(y), t(s2), n_real)
    vg = NJ.get_fns(spec_j, user_noise, False, padded=padded)["nlz_grad"]
    args_j = [j(X), j(y)] + ([j(s2)] if user_noise else []) + (
        [n_j] if padded else [])
    for s in range(hyp.shape[0]):
        v_j, g_j = vg(j(hyp[s]), *args_j)
        assert _rel(v_t[s].item(), v_j) < RTOL
        assert _rel(g_t[s].numpy(), g_j) < RTOL
        assert _rel(chain_t[s].item(), v_j) < RTOL
        assert _rel(design_t[s].item(), v_j) < RTOL
    # The warp's log-Jacobian is in the value: without the warp it differs.
    plain = MT.ModelSpec(**{**spec_t.__dict__, "outwarp": None})
    v_plain = NT.nlz(plain, hyp[:, : plain.hyp_N], t(X), t(y), t(s2), n_real)
    assert torch.all(torch.abs(v_plain - v_t) > 1e-3)


def _make(m, warp=None, **kw):
    ow = None if warp is None else getattr(m.outwarp_functions, warp)()
    return m.GP(D, m.covariance_functions.SquaredExponential(),
                m.mean_functions.ConstantMean(),
                m.noise_functions.GaussianNoise(constant_add=True),
                outwarp=ow, **kw)


MAP_OPTS = {"n_samples": 0, "init_N": 16, "opts_N": 2, "tol_opt": 1e-8,
            "optimizer_backend": "scipy"}
SAMPLE_OPTS = {"n_samples": 3, "thin": 2, "burn": 4, "init_N": 16, "opts_N": 0}
SIDES = (("jax", gj, {}), ("torch", gt, {"device": "cpu"}))


def _fit(m, kw, options, warp="NegativePowerC1", seed=1):
    X, y = _data()
    g = _make(m, **kw)
    np.random.seed(seed)
    out = g.fit(X, y, options={**options,
                               "outwarp_fun": getattr(m.outwarp_functions, warp)()})
    return g, out


@pytest.fixture(scope="module")
def fits():
    out = {side: _fit(m, kw, MAP_OPTS) for side, m, kw in SIDES}
    with pytest.MonkeyPatch.context() as mp:
        patch_streams(mp)
        for side, m, kw in SIDES:
            out["sample", side] = _fit(m, kw, SAMPLE_OPTS, warp="NegativePower")
    return out


def test_map_fit_with_outwarp_fun_matches_jax(fits):
    g_j, (hyp_j, res_j, _) = fits["jax"]
    g_t, (hyp_t, res_t, sr_t) = fits["torch"]
    assert sr_t is None and hyp_t.shape == hyp_j.shape == (1, D + 5)
    assert g_t.outwarp._kind == "negpowc1" and g_t._hyp_N() == D + 5
    assert [n for n, _ in g_t._hyper_info()] == [n for n, _ in g_j._hyper_info()]
    assert np.array_equal(g_t.lower_bounds, g_j.lower_bounds)
    assert np.array_equal(g_t.upper_bounds, g_j.upper_bounds)
    assert np.max(np.abs(hyp_t - hyp_j)) < 1e-4
    scale = max(1.0, abs(res_j.fun))
    assert abs(res_t.fun - res_j.fun) < 1e-5 * scale
    # The objective at the port's MAP, in both packages' arithmetic.
    assert abs(float(g_j._objective(hyp_t[0])) - res_t.fun) < 1e-8 * scale


def _served_pair(fits):
    """Both packages' GPs at the port's MAP with the noise set to a
    moderate sn = 0.1: the MAP's own noise sits at the floor (log sn =
    -11), where the two factorizations differ by the conditioning, as
    the rank-1 tests note."""
    g_t, (hyp_t, _, _) = fits["torch"]
    hyp = hyp_t.copy()
    hyp[:, D + 1] = np.log(0.1)
    out = []
    for m, kw in ((gt, {"device": "cpu"}), (gj, {})):
        g = _make(m, "NegativePowerC1", **kw)
        g.update(X_new=g_t.X, y_new=g_t.y, hyp=hyp)
        out.append(g)
    return out


@pytest.mark.parametrize("separate", [False, True], ids=["mixture", "separate"])
@pytest.mark.parametrize("add_noise", [False, True], ids=["latent", "noisy"])
def test_predict_with_lpd_matches_jax(fits, add_noise, separate):
    g_t, g_j = _served_pair(fits)
    rng = np.random.default_rng(3)
    xs = rng.uniform(-3, 3, (9, D))
    ys = -0.5 * np.sum(xs**2, axis=1, keepdims=True)
    out_t = g_t.predict(xs, ys, add_noise=add_noise, separate_samples=separate,
                        return_lpd=True)
    out_j = g_j.predict(xs, ys, add_noise=add_noise, separate_samples=separate,
                        return_lpd=True)
    for a, b in zip(out_t, out_j):
        assert _rel(a, b) < RTOL


@pytest.mark.parametrize("observed", [True, False])
def test_predict_quantile_with_outwarp_matches_jax(fits, observed):
    g_t, g_j = _served_pair(fits)
    xs = np.random.default_rng(4).uniform(-3, 3, (6, D))
    q = [0.1, 0.5, 0.9]
    a = g_t.predict_quantile(q, xs, observed=observed)
    b = g_j.predict_quantile(q, xs, observed=observed)
    assert a.shape == b.shape == (6, 3)
    assert _rel(a, b) < RTOL


def test_predict_full_and_quad_refuse_a_warped_gp(fits):
    g_t, g_j = _served_pair(fits)
    for g in (g_t, g_j):
        with pytest.raises(ValueError, match="output warping"):
            g.predict_full(np.zeros((2, D)))
        with pytest.raises(ValueError, match="output warping"):
            g.quad(0.0, 1.0)


def test_single_point_update_of_a_warped_gp_rebuilds(fits):
    g_t, g_j = _served_pair(fits)
    hyp = g_t.get_hyperparameters(as_array=True)
    x_new = np.array([[0.3, -0.4]])
    y_new = -0.5 * np.sum(x_new**2, axis=1, keepdims=True)
    g_t.update(X_new=x_new, y_new=y_new)
    g_j.update(X_new=x_new, y_new=y_new)
    rebuilt = _make(gt, "NegativePowerC1", device="cpu")
    rebuilt.update(X_new=g_t.X, y_new=g_t.y, hyp=hyp)
    p, r = g_t.posteriors[0], rebuilt.posteriors[0]
    assert p.L.shape == (N + 1, N + 1)
    for name in ("alpha", "sW", "L"):
        assert torch.equal(getattr(p, name), getattr(r, name)), name
    assert _rel(p.alpha.numpy(), np.asarray(g_j.posteriors[0].alpha)) < RTOL


def test_jax_saved_warped_gp_loads_in_the_port(fits, tmp_path):
    g_j = fits["jax"][0]
    path = tmp_path / "warped.npz"
    g_j.save(path)
    g_t = gt.GP.load(path, device="cpu")
    assert isinstance(g_t.outwarp, gt.outwarp_functions.NegativePowerC1)
    assert np.array_equal(g_t.get_hyperparameters(as_array=True),
                          g_j.get_hyperparameters(as_array=True))
    xs = np.random.default_rng(5).uniform(-3, 3, (7, D))
    mu_t, s2_t = g_t.predict(xs)
    mu_j, s2_j = g_j.predict(xs)
    assert np.max(np.abs(mu_t - mu_j)) < 1e-10
    assert np.max(np.abs(s2_t - s2_j)) < 1e-7
    # And back: the port's file names the warp for the JAX package.
    g_t.save(tmp_path / "port.npz")
    assert isinstance(gj.GP.load(tmp_path / "port.npz").outwarp,
                      gj.outwarp_functions.NegativePowerC1)


def test_sampled_warped_fit_equals_the_jax_chain(fits):
    g_j, (hyp_j, _, sr_j) = fits["sample", "jax"]
    g_t, (hyp_t, _, sr_t) = fits["sample", "torch"]
    assert hyp_t.shape == hyp_j.shape == (3, D + 5)
    for k in ("samples", "f_vals", "log_priors"):
        a, b = np.asarray(sr_t[k]), np.asarray(sr_j[k])
        assert np.max(np.abs(a - b)) <= RTOL * max(1.0, np.max(np.abs(b))), k
    assert sr_t["exit_flag"] == sr_j["exit_flag"]
    xs = np.random.default_rng(6).uniform(-3, 3, (5, D))
    mu_t, s2_t = g_t.predict(xs)
    mu_j, s2_j = g_j.predict(xs)
    assert np.max(np.abs(mu_t - mu_j)) < 1e-10
    assert np.max(np.abs(s2_t - s2_j)) < 1e-7
