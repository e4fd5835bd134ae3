"""The recommended bounds of every covariance, mean and noise object, the
GP's ``get_recommended_bounds`` / ``get_priors`` and the float32 noise
floor, against ``gpyreg_tpu`` on the same numpy inputs.  Everything here
is host-side numpy in both packages, so the tolerance is 1e-12 absolute
(infinite entries must be the same infinities)."""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt

torch.set_num_threads(1)

ATOL = 1e-12
KEYS = ("LB", "UB", "PLB", "PUB", "x0")


def _data(N=37, D=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 3, (N, D)) * np.array([1.0, 0.3, 4.0])[:D]
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))
    return X, y


def _same(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    fin = np.isfinite(b)
    assert np.array_equal(a[~fin], b[~fin], equal_nan=True)
    assert np.all(np.abs(a[fin] - b[fin]) <= ATOL), np.max(np.abs(a[fin] - b[fin]))


def _same_info(info_t, info_j):
    assert set(info_t) == set(info_j) == set(KEYS)
    for k in KEYS:
        _same(info_t[k], info_j[k])


COVS = {
    "se": lambda m: m.covariance_functions.SquaredExponential(),
    "m1": lambda m: m.covariance_functions.Matern(1),
    "m3": lambda m: m.covariance_functions.Matern(3),
    "m5": lambda m: m.covariance_functions.Matern(5),
    "rq": lambda m: m.covariance_functions.RationalQuadraticARD(),
    "se_iso": lambda m: m.isotropic_covariance_functions.SquaredExponentialIsotropic(),
    "m3_iso": lambda m: m.isotropic_covariance_functions.MaternIsotropic(3),
    "m5_iso": lambda m: m.isotropic_covariance_functions.MaternIsotropic(5),
}


@pytest.mark.parametrize("kind", sorted(COVS))
@pytest.mark.parametrize("n_y", [37, 1])
def test_covariance_bounds_info(kind, n_y):
    X, y = _data()
    _same_info(COVS[kind](gt).get_bounds_info(X, y[:n_y]),
               COVS[kind](gj).get_bounds_info(X, y[:n_y]))


def _bowl_t(h, X):
    return h[0] - torch.sum((X - h[1]) ** 2, dim=1)


def _bowl_j(h, X):
    import jax.numpy as jnp

    return h[0] - jnp.sum((X - h[1]) ** 2, axis=1)


def _custom_box(X, y):
    return {"LB": np.array([-5.0, -1.0]), "UB": np.array([5.0, 1.0]),
            "PLB": np.array([-1.0, -0.5]), "PUB": np.array([1.0, 0.5]),
            "x0": np.array([0.0, 0.1])}


MEANS = {
    "zero": lambda m: m.mean_functions.ZeroMean(),
    "const": lambda m: m.mean_functions.ConstantMean(),
    "negquad": lambda m: m.mean_functions.NegativeQuadratic(),
    "linear": lambda m: m.mean_functions.LinearMean(),
    "quad": lambda m: m.mean_functions.QuadraticMean(),
    "posquad": lambda m: m.mean_functions.PositiveQuadratic(),
    "se_mean": lambda m: m.mean_functions.SquaredExponentialMean(),
    "negse_mean": lambda m: m.mean_functions.NegativeSquaredExponentialMean(),
    "custom": lambda m: m.mean_functions.CustomMean(
        _bowl_t if m is gt else _bowl_j, 2, name="bounds_test_bowl"),
    "custom_fn": lambda m: m.mean_functions.CustomMean(
        _bowl_t if m is gt else _bowl_j, 2, name="bounds_test_bowl",
        bounds_info_fn=_custom_box),
}


@pytest.mark.parametrize("kind", sorted(MEANS))
@pytest.mark.parametrize("n_y", [37, 1])
def test_mean_bounds_info(kind, n_y):
    X, y = _data(seed=1)
    _same_info(MEANS[kind](gt).get_bounds_info(X, y[:n_y]),
               MEANS[kind](gj).get_bounds_info(X, y[:n_y]))


NOISES = {
    "none": {},
    "const": dict(constant_add=True),
    "user": dict(user_provided_add=True),
    "user_scaled": dict(user_provided_add=True, scale_user_provided=True),
    "rect": dict(rectified_linear_output_dependent_add=True),
    "const_rect": dict(constant_add=True,
                       rectified_linear_output_dependent_add=True),
    "all": dict(constant_add=True, user_provided_add=True,
                scale_user_provided=True,
                rectified_linear_output_dependent_add=True),
}


@pytest.mark.parametrize("kind", sorted(NOISES))
@pytest.mark.parametrize("n_y", [37, 1])
def test_noise_bounds_info(kind, n_y):
    X, y = _data(seed=2)
    _same_info(
        gt.noise_functions.GaussianNoise(**NOISES[kind]).get_bounds_info(X, y[:n_y]),
        gj.noise_functions.GaussianNoise(**NOISES[kind]).get_bounds_info(X, y[:n_y]),
    )


def _gps(cov="rq", mean="negquad", noise="const_rect", dtype=None, N=37, D=3):
    X, y = _data(N=N, D=D, seed=3)
    out = []
    for m, kw in ((gj, {}), (gt, {"device": "cpu"})):
        g = m.GP(D, COVS[cov](m), MEANS[mean](m),
                 m.noise_functions.GaussianNoise(**NOISES[noise]),
                 dtype=dtype, **kw)
        g.X, g.y = X, y
        out.append(g)
    return out


def _same_dict(d_t, d_j):
    assert list(d_t) == list(d_j)
    for k in d_j:
        _same(d_t[k][0], d_j[k][0])
        _same(d_t[k][1], d_j[k][1])


@pytest.mark.parametrize("cov,mean,noise", [
    ("rq", "negquad", "const_rect"),
    ("se", "const", "const"),
    ("m5_iso", "se_mean", "all"),
    ("m3", "zero", "user_scaled"),
])
def test_get_recommended_bounds(cov, mean, noise):
    g_j, g_t = _gps(cov, mean, noise)
    _same_dict(g_t.get_recommended_bounds(), g_j.get_recommended_bounds())
    _same_dict(g_t.get_recommended_bounds("recommended", None),
               g_j.get_recommended_bounds("recommended", None))
    # Arrays with NaN holes: the holes take the recommendation, and an
    # upper bound below the lower one is raised to it.
    n = g_j._hyp_N()
    lb = np.full(n, np.nan)
    ub = np.full(n, np.nan)
    lb[0], ub[0] = -0.5, -0.75
    lb[-1] = 0.25
    _same_dict(g_t.get_recommended_bounds(lb, ub),
               g_j.get_recommended_bounds(lb, ub))
    # "current": what set_bounds stored, NaN where it stored nothing.
    for g in (g_j, g_t):
        names = [name for name, *_ in g._hyper_info()]
        g.set_bounds({k: ((-1.0, 2.0) if i == 0 else None)
                      for i, k in enumerate(names)})
    _same_dict(g_t.get_recommended_bounds("current", "current"),
               g_j.get_recommended_bounds("current", "current"))
    with pytest.raises(ValueError, match="recommended"):
        g_t.get_recommended_bounds("nonsense")


def test_get_recommended_bounds_needs_data():
    g = gt.GP(2, COVS["se"](gt), MEANS["const"](gt),
              gt.noise_functions.GaussianNoise(constant_add=True),
              device="cpu")
    with pytest.raises(ValueError, match="X or y"):
        g.get_recommended_bounds()


def test_get_priors_round_trip():
    priors = {
        "covariance_log_lengthscale": ("gaussian", (0.1, 1.5)),
        "covariance_log_outputscale": ("student_t", (0.0, 2.0, 4.0)),
        "covariance_log_shape": None,
        "noise_log_scale": ("smoothbox", (-4.0, -1.0, 0.5)),
        "noise_rectified_log_multiplier":
            ("smoothbox_student_t", (-1.0, 1.0, 0.5, 3.0)),
        "mean_const": None,
        "mean_location": ("gaussian", (0.0, 2.0)),
        "mean_log_scale": None,
    }
    g_j, g_t = _gps()
    assert g_t.get_priors() == g_j.get_priors()  # all None
    for g in (g_j, g_t):
        g.set_priors(priors)
    p_t, p_j = g_t.get_priors(), g_j.get_priors()
    assert list(p_t) == list(p_j)
    for name, want in priors.items():
        if want is None:
            assert p_t[name] is None and p_j[name] is None
            continue
        assert p_t[name][0] == p_j[name][0] == want[0]
        for a, b in zip(p_t[name][1], p_j[name][1]):
            _same(a, b)


FLOOR_CASES = {
    "auto_large": (np.float32, 4096, "const", {}),
    "auto_small": (np.float32, 64, "const", {}),
    "forced_small": (np.float32, 64, "const", {"f32_noise_floor": True}),
    "off": (np.float32, 4096, "const", {"f32_noise_floor": False}),
    "none": (np.float32, 4096, "const", {"f32_noise_floor": None}),
    "explicit": (np.float32, 64, "const", {"f32_noise_floor": -2.5}),
    "explicit_above_ub": (np.float32, 64, "const", {"f32_noise_floor": 9.0}),
    "explicit_below_lb": (np.float32, 64, "const", {"f32_noise_floor": -30.0}),
    "float64": (np.float64, 4096, "const", {}),
    "no_constant_noise": (np.float32, 4096, "rect", {}),
}


@pytest.mark.parametrize("case", sorted(FLOOR_CASES))
def test_f32_noise_floor(case):
    dtype, N, noise, options = FLOOR_CASES[case]
    g_j, g_t = _gps("se", "const", noise, dtype=dtype, N=N)
    cov_N = 4
    n = g_j._hyp_N()
    LB, UB = np.full(n, -13.0), np.full(n, 3.0)
    out_j = g_j._f32_noise_floor(LB, UB, cov_N, options)
    out_t = g_t._f32_noise_floor(LB, UB, cov_N, options)
    _same(out_t, out_j)
    assert np.all(LB == -13.0)  # the caller's array is never written
    raised = case in ("auto_large", "forced_small", "explicit",
                      "explicit_above_ub")
    assert (out_t[cov_N] > LB[cov_N]) == raised
    assert np.array_equal(np.delete(out_t, cov_N), np.delete(LB, cov_N))
    assert (gt.GP._F32_NOISE_FLOOR_C, gt.GP._F32_NOISE_FLOOR_MIN_N) == (
        gj.GP._F32_NOISE_FLOOR_C, gj.GP._F32_NOISE_FLOOR_MIN_N)
