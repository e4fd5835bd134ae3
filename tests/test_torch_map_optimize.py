"""The port's hand-written multistart L-BFGS against the JAX package's
optax program and scipy's L-BFGS-B, on the CPU in float64.

- the bound transform ``to_x`` / ``to_z`` of all five bound kinds: 1e-12
  absolute against the JAX closures, and their round trip;
- start selection (ranking with failures last, the low-noise second
  start, the widths): identical rows given the same design and values;
- the optimum: objective within 1e-6 * max(1, |f|) of the JAX package's
  and of scipy's, hyperparameters within 1e-3 (the iterates differ, the
  optimum does not);
- the line search and the stop rule on their own (no JAX involved)."""

import math

import numpy as np
import pytest
import scipy.optimize
import torch

import jax.numpy as jnp

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt
from gpyreg_tpu.inference import map_optimize as mj
from gpyreg_tpu_torch.inference import map_optimize as mt

torch.set_num_threads(1)

LB5 = np.array([-1.0, 0.0, -np.inf, -np.inf, 2.0])
UB5 = np.array([1.0, np.inf, 5.0, np.inf, 2.0])  # last dimension pinned


def test_transform_matches_jax_for_all_bound_kinds():
    """to_x and to_z against the JAX closures at 1e-12 absolute, on
    interior points, on points at and beyond the bounds (the 1e-12 and
    1e-300 guards) and on |z| beyond the cap."""
    to_x_j, to_z_j, bp_j = mj._make_transform(LB5, UB5)
    to_x_t, to_z_t, bp_t = mt._make_transform(LB5, UB5)
    assert np.array_equal(bp_t, np.asarray(bp_j))
    rng = np.random.default_rng(0)
    zs = np.concatenate([
        rng.normal(size=(20, 5)) * 3,
        np.array([[50.0, -30.0, 10.0, -3.0, 0.0],
                  [-50.0, 30.0, -10.0, 3.0, 7.0],
                  [2e4, -2e4, -2e4, 2e4, 0.0]]),
    ])
    for z in zs:
        want = np.asarray(to_x_j(jnp.asarray(z), bp_j))
        got = to_x_t(torch.as_tensor(z), bp_t).numpy()
        fin = np.isfinite(want)
        assert np.array_equal(got[~fin], want[~fin])
        assert np.max(np.abs(got[fin] - want[fin])
                      / np.maximum(1.0, np.abs(want[fin]))) <= 1e-12
        assert got[-1] == 2.0
    xs = np.array([[0.3, 1.7, -2.2, 0.9, 2.0],
                   [-1.0, 0.0, 5.0, -4.0, 2.0],    # on the bounds
                   [1.0, 1e-320, 5.0 - 1e-310, 0.0, 2.0],
                   [-1.5, -1.0, 6.0, 123.0, 2.0]])  # outside
    for x in xs:
        want = np.asarray(to_z_j(jnp.asarray(x), bp_j))
        got = to_z_t(torch.as_tensor(x), bp_t).numpy()
        assert np.max(np.abs(got - want)) <= 1e-12 * max(1.0, np.max(np.abs(want)))
    # A stack of rows transforms row by row.
    Z = to_z_t(torch.as_tensor(xs), bp_t)
    assert Z.shape == (4, 5)
    assert torch.equal(Z[0], to_z_t(torch.as_tensor(xs[0]), bp_t))


def test_transform_round_trip_and_box():
    to_x, to_z, bp = mt._make_transform(LB5, UB5)
    x = torch.tensor([0.3, 1.7, -2.2, 0.9, 2.0], dtype=torch.float64)
    assert torch.max(torch.abs(to_x(to_z(x, bp), bp) - x)) < 1e-9
    z = torch.tensor([50.0, -30.0, 10.0, -3.0, 0.0], dtype=torch.float64)
    x2 = to_x(z, bp).numpy()
    assert np.all(x2 >= LB5 - 1e-12) and np.all(x2 <= UB5 + 1e-12)
    # The derivative of a pinned dimension is zero, of a free one 1.
    z = z.requires_grad_(True)
    (g,) = torch.autograd.grad(to_x(z, bp).sum(), z)
    assert g[-1] == 0.0 and g[3] == 1.0 and torch.all(torch.isfinite(g))


def _host_selection(design, ys, k, low_idx):
    """The reference's host logic (gaussian_process.py:1097-1125)."""
    ys = np.where(np.isfinite(ys), ys, np.inf)
    order = np.argsort(ys, kind="stable")
    X0, y0 = design[order], ys[order]
    starts = X0[:k].copy()
    if low_idx is not None and 1 < k < len(ys):
        xx, noise_y = X0[k:], y0[k:]
        nz = np.argsort(xx[:, low_idx], kind="stable")
        cand = nz[: max(1, math.ceil(0.2 * len(noise_y)))]
        starts[1] = xx[cand[np.argmin(noise_y[cand])]]
    return starts, X0, y0


@pytest.mark.parametrize("opts_N,low_idx", [(3, 1), (3, None), (1, 1), (2, 0)])
def test_start_selection_matches_jax(opts_N, low_idx):
    """With ``max_iter=0`` the optimizer returns its starts: both
    packages must pick the same rows of the same design, sort the design
    alike (ties and failures included) and report the same widths."""
    rng = np.random.default_rng(1)
    n, B0 = 4, 48
    design = rng.normal(size=(B0, n))
    design[5] = design[9]  # a tie: the sort must be stable
    LB, UB = np.full(n, -10.0), np.full(n, 10.0)

    def obj_j(h):
        v = jnp.sum((h - 0.5) ** 2)
        return jnp.where(h[0] > 1.2, jnp.nan, v)  # failed evaluations

    def obj_t(h):
        v = torch.sum((h - 0.5) ** 2)
        return torch.where(h[0] > 1.2, torch.full_like(v, math.nan), v)

    kw = dict(tol=1e-8, opts_N=opts_N, low_noise_idx=low_idx, max_iter=0)
    xs_j, fs_j, _, w_j, Xs_j, ys_j = mj.design_optimize(
        obj_j, design, LB, UB, chunk=16, **kw)
    xs_t, fs_t, res_t, w_t, Xs_t, ys_t = mt.design_optimize(
        obj_t, design, LB, UB, chunk=7, device="cpu", **kw)
    assert np.array_equal(Xs_t, np.asarray(Xs_j))
    assert np.array_equal(np.isinf(ys_t), np.isinf(np.asarray(ys_j)))
    assert np.sum(np.isinf(ys_t)) == np.sum(design[:, 0] > 1.2) > 0
    fin = np.isfinite(ys_t)
    assert np.max(np.abs(ys_t[fin] - np.asarray(ys_j)[fin])) < 1e-12
    assert np.max(np.abs(w_t - np.asarray(w_j))) < 1e-12
    assert np.max(np.abs(xs_t - xs_j)) < 1e-9  # the transform's round trip
    ys = np.array([float(obj_t(torch.as_tensor(h))) for h in design])
    starts, X0, y0 = _host_selection(design, ys, opts_N, low_idx)
    assert np.array_equal(Xs_t, X0)
    assert np.max(np.abs(xs_t - starts)) < 1e-9
    assert [r.nit for r in res_t] == [0] * opts_N
    got = mt._select_starts(design, ys, opts_N, low_idx)
    assert np.array_equal(got[0], starts) and np.array_equal(got[2], X0)
    assert np.array_equal(got[1], np.std(design, axis=0, ddof=1))


def test_select_starts_single_row_design():
    starts, widths, Xs, ys = mt._select_starts(
        np.array([[1.0, 2.0]]), np.array([3.0]), 3, 1)
    assert starts.shape == (1, 2) and np.array_equal(widths, [0.0, 0.0])


def test_design_f_args_rank_on_subset_optimize_on_full():
    """``design_f_args`` ranks with other arguments than the optimization
    uses (the ``design_subset`` knob of ``GP.fit``)."""
    def obj(h, c):
        return torch.sum((h - c) ** 2)

    design = np.array([[1.5], [0.1], [3.0]])
    LB, UB = np.array([-10.0]), np.array([10.0])
    timings = {}
    xs, fs, results, widths, Xs, ys = mt.design_optimize(
        obj, design, LB, UB, f_args=(0.0,), design_f_args=(2.0,),
        tol=1e-10, opts_N=1, device="cpu", timings=timings)
    np.testing.assert_allclose(Xs, [[1.5], [3.0], [0.1]], atol=1e-12)
    np.testing.assert_allclose(ys, [0.25, 1.0, 3.61], atol=1e-10)
    np.testing.assert_allclose(xs, 0.0, atol=1e-5)
    assert fs[0] < 1e-8 and timings["rank_s"] > 0


def test_bounded_quadratic_matches_jax():
    """min (x - c)^2 with c partly outside the box
    (tests/test_map_optimize.py:36): same optimum as the JAX package."""
    c = np.array([0.5, 2.0, -3.0])
    LB, UB = np.full(3, -1.0), np.full(3, 1.0)
    starts = np.array([[0.0, 0.0, 0.0], [0.9, -0.9, 0.5]])
    xs_j, fs_j, _ = mj.multistart_map(
        lambda x: jnp.sum((x - jnp.asarray(c)) ** 2), starts, LB, UB, tol=1e-10)
    ct = torch.as_tensor(c)
    xs_t, fs_t, res_t = mt.multistart_map(
        lambda x: torch.sum((x - ct) ** 2), starts, LB, UB, tol=1e-10,
        device="cpu")
    f_star = 1.0 + 4.0  # (2 - 1)^2 + (-3 + 1)^2 at the corner
    for x, f, r in zip(xs_t, fs_t, res_t):
        assert abs(x[0] - 0.5) < 1e-5
        assert x[1] > 1.0 - 1e-3 and x[1] < 1.0  # strictly inside
        assert x[2] < -1.0 + 1e-3 and x[2] > -1.0
        assert r.success and r.fun == f and np.array_equal(r.x, x)
        assert r.stop in ("gradient", "objective_drop", "step")
    assert np.max(np.abs(fs_t - fs_j)) < 1e-6 * max(1.0, f_star)
    assert np.max(np.abs(fs_t - f_star)) < 1e-3
    assert abs(xs_t[0, 0] - xs_j[0, 0]) < 1e-3


def test_fixed_dimension_stays_pinned():
    LB = np.array([-2.0, 0.7, -np.inf])
    UB = np.array([2.0, 0.7, 4.0])
    c = torch.tensor([1.0, -5.0, 3.0], dtype=torch.float64)
    xs, fs, res = mt.multistart_map(
        lambda x: torch.sum((x - c) ** 2), np.array([[0.0, 0.7, 0.0]]),
        LB, UB, tol=1e-10, device="cpu")
    assert xs[0, 1] == 0.7
    assert abs(xs[0, 0] - 1.0) < 1e-5 and abs(xs[0, 2] - 3.0) < 1e-5
    assert abs(fs[0] - 5.7**2) < 1e-8


@pytest.fixture(scope="module")
def gp_pair():
    rng = np.random.default_rng(0)
    N, D = 60, 2
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))

    def make(m, **kw):
        g = m.GP(D, m.covariance_functions.SquaredExponential(),
                 m.mean_functions.ConstantMean(),
                 m.noise_functions.GaussianNoise(constant_add=True), **kw)
        g.X, g.y = X, y
        return g

    return make(gj), make(gt, device="cpu")


def test_gp_objective_optimum_matches_jax_and_scipy(gp_pair):
    """A float64 GP objective (N=60, D=2): the port's optimum against
    the JAX package's multistart program and scipy's L-BFGS-B from the
    same start.  Objective within 1e-6 * max(1, |f|), hyperparameters
    within 1e-3."""
    g_j, g_t = gp_pair
    LB, UB = np.full(5, -8.0), np.full(5, 8.0)
    starts = np.array([[0.1, 0.1, 0.2, -1.0, 0.0],
                       [0.5, 0.4, 0.0, -2.0, 0.1]])
    fns_j, args_j = g_j._obj_args()
    xs_j, fs_j, _ = mj.multistart_map(
        fns_j["obj_raw"], starts, LB, UB, f_args=args_j, tol=1e-9)
    fns_t, args_t = g_t._obj_args()
    xs_t, fs_t, res_t = mt.multistart_map(
        fns_t["obj_raw"], starts, LB, UB, f_args=args_t, tol=1e-9)
    for i in range(2):
        ref = scipy.optimize.minimize(
            fun=lambda h: g_t._objective(h, grad=True), x0=starts[i],
            jac=True, bounds=list(zip(LB, UB)), tol=1e-12)
        scale = max(1.0, abs(ref.fun))
        assert abs(fs_t[i] - fs_j[i]) < 1e-6 * scale
        assert abs(fs_t[i] - ref.fun) < 1e-6 * scale
        assert np.max(np.abs(xs_t[i] - xs_j[i])) < 1e-3
        assert np.max(np.abs(xs_t[i] - ref.x)) < 1e-3
        # The reported value is the objective at the reported point.
        assert abs(g_t._objective(xs_t[i]) - fs_t[i]) < 1e-9 * scale
        assert res_t[i].nit > 0 and res_t[i].grad_norm < 1e-2


def test_design_optimize_on_gp_matches_jax(gp_pair):
    """Ranking through ``obj_design_raw`` and optimizing through
    ``obj_raw``: same sorted design, same best optimum."""
    g_j, g_t = gp_pair
    rng = np.random.default_rng(4)
    LB, UB = np.full(5, -8.0), np.full(5, 8.0)
    design = rng.uniform(-2.5, 1.5, (24, 5))
    design[:, 3] = rng.uniform(-6, -1, 24)
    out = []
    for g, m, kw in ((g_j, mj, {}), (g_t, mt, {})):
        fns, args = g._obj_args()
        out.append(m.design_optimize(
            fns["obj_raw"], design, LB, UB, f_args=args, tol=1e-8, opts_N=2,
            low_noise_idx=3, chunk=8, obj_design_raw=fns["obj_design_raw"],
            **kw))
    (xs_j, fs_j, _, w_j, Xs_j, ys_j), (xs_t, fs_t, _, w_t, Xs_t, ys_t) = out
    assert np.array_equal(Xs_t, np.asarray(Xs_j))
    assert np.max(np.abs(ys_t - np.asarray(ys_j)) / np.abs(ys_t)) < 1e-8
    assert np.max(np.abs(w_t - w_j)) < 1e-12
    assert abs(fs_t.min() - fs_j.min()) < 1e-6 * max(1.0, abs(fs_j.min()))


def test_lbfgs_on_rosenbrock_matches_scipy():
    """The optimizer alone on a curved valley: scipy's optimum, in a
    number of iterations of scipy's order."""
    def fun(z):
        f = scipy.optimize.rosen(z)
        return float(f), scipy.optimize.rosen_der(z)

    z0 = np.array([-1.2, 1.0, -0.5, 0.8])
    z, it, stop, gnorm = mt._lbfgs_minimize(fun, z0, 1e-12, 500, 10)
    ref = scipy.optimize.minimize(scipy.optimize.rosen, z0,
                                  jac=scipy.optimize.rosen_der,
                                  method="L-BFGS-B", tol=1e-14)
    assert stop in ("gradient", "objective_drop") and gnorm < 1e-6
    assert 0 < it < 2 * ref.nit
    assert np.max(np.abs(z - 1.0)) < 1e-6
    assert abs(fun(z)[0] - ref.fun) < 1e-12


@pytest.mark.parametrize("rule", ["gradient_at_start", "max_iter",
                                  "objective_drop", "non_finite_start"])
def test_stop_rules(rule):
    def quad(z):
        return float(np.sum(z**2)), 2 * z

    if rule == "gradient_at_start":
        z, it, stop, _ = mt._lbfgs_minimize(quad, np.zeros(3), 1e-5, 500, 10)
        assert (it, stop) == (0, "gradient")
    elif rule == "max_iter":
        def fun(z):
            return (float(scipy.optimize.rosen(z)),
                    scipy.optimize.rosen_der(z))
        z, it, stop, _ = mt._lbfgs_minimize(
            fun, np.array([-1.2, 1.0]), 1e-12, 3, 10)
        assert (it, stop) == (3, "max_iter")
    elif rule == "objective_drop":
        # A flat valley: the value stops moving long before the gradient
        # in the steep direction's scale is below tol.
        def fun(z):
            return float(1e-9 * z[0] ** 2 + 1e4), np.array([2e-9 * z[0]]) + 1e-4
        z, it, stop, _ = mt._lbfgs_minimize(fun, np.array([3.0]), 1e-5, 500, 10)
        assert stop == "objective_drop" and it >= 1
    else:
        z, it, stop, g = mt._lbfgs_minimize(
            lambda z: (math.inf, np.zeros_like(z)), np.ones(2), 1e-5, 500, 10)
        assert (it, stop, g) == (0, "non_finite", math.inf)
        assert np.array_equal(z, np.ones(2))


def test_non_finite_region_makes_the_search_back_off():
    """Beyond x > 1 the objective is NaN, as when a factorization fails
    at every jitter, and the finite part falls towards that edge.
    Nothing raises, no iterate enters the region, and the lane ends at a
    finite value below its start's."""
    seen = []

    def obj(x):
        seen.append(float(x[0].detach()))
        v = torch.sum((x - 3.0) ** 2)
        return torch.where(x[0] > 1.0, torch.full_like(v, math.nan), v)

    xs, fs, res = mt.multistart_map(
        obj, np.array([[-4.0, 0.0]]), np.full(2, -10.0), np.full(2, 10.0),
        tol=1e-8, device="cpu")
    assert any(s > 1.0 for s in seen)  # the search did try the region
    assert np.isfinite(fs[0]) and res[0].success
    assert xs[0, 0] <= 1.0 and fs[0] < 49.0 + 9.0 - 30.0
    assert fs[0] == float(obj(torch.as_tensor(xs[0])))


def test_zoom_linesearch_meets_strong_wolfe():
    """One search along the steepest descent of a quartic: the returned
    step satisfies both Wolfe conditions with c1 = 1e-4, c2 = 0.9."""
    def f(t):
        return (t - 2.0) ** 4 + 0.5 * t, 4 * (t - 2.0) ** 3 + 0.5

    f0, s0 = f(0.0)
    n = []

    def phi(t):
        n.append(t)
        v, s = f(t)
        return v, np.array([s]), s

    t, ft, gt_ = mt._zoom_linesearch(phi, f0, s0)
    assert n[0] == 1.0 and len(n) <= 20
    assert ft <= f0 + 1e-4 * t * s0
    assert abs(gt_[0]) <= 0.9 * abs(s0)
    # No point with sufficient decrease: the search reports step 0.
    t, ft, gt_ = mt._zoom_linesearch(
        lambda t: (f0 + 1.0, np.array([1.0]), 1.0), f0, s0)
    assert (t, ft, gt_) == (0.0, None, None)


def test_device_defaults_to_the_tensors_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    LB, UB = np.full(2, -1.0), np.full(2, 1.0)
    obj = lambda x, c: torch.sum((x - c) ** 2)
    c = torch.zeros(2, dtype=torch.float64)
    xs, _, _ = mt.multistart_map(obj, np.full((1, 2), 0.5), LB, UB, f_args=(c,))
    assert np.max(np.abs(xs)) < 1e-4
    with pytest.raises(RuntimeError, match="CUDA"):
        mt.multistart_map(lambda x: torch.sum(x**2), np.full((1, 2), 0.5), LB, UB)
