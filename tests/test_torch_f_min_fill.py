"""The space-filling design of the port against ``gpyreg_tpu.f_min_fill``:
the same ``np.random.seed`` gives both packages the same design, for both
designs, every prior family and a pinned dimension; the quantile functions
and ``uuinv`` agree pointwise.  Host numpy/scipy on both sides: 1e-12
absolute."""

import numpy as np
import pytest
import torch

import gpyreg_tpu.f_min_fill as fj
import gpyreg_tpu_torch.f_min_fill as ft

torch.set_num_threads(1)

ATOL = 1e-12


def _table(n, **rows):
    t = {k: np.full((n,), np.nan) for k in ("mu", "sigma", "df", "a", "b")}
    for k, v in rows.items():
        t[k][:] = v
    return t


def _box(n=5):
    LB = np.array([-6.0, -4.0, -8.0, -3.0, -2.0])[:n]
    UB = np.array([4.0, 5.0, 1.0, 6.0, 7.0])[:n]
    PLB = np.array([-2.0, -1.0, -4.0, 0.0, 0.5])[:n]
    PUB = np.array([1.0, 2.0, -1.0, 3.0, 4.0])[:n]
    return LB, UB, PLB, PUB


def _priors(kind, n=5):
    """A prior table whose every row is of one family, df as GP.fit
    leaves it (NaN filled with df_base = 7 for the light-tailed rows the
    table marks with 0)."""
    if kind == "uniform":
        return _table(n)
    if kind == "gaussian":
        return _table(n, mu=0.3, sigma=1.2, df=0)
    if kind == "student_t":
        return _table(n, mu=-0.2, sigma=0.8, df=4.0)
    if kind == "student_t_df_nan":
        return _table(n, mu=-0.2, sigma=0.8)
    if kind == "smoothbox":
        return _table(n, a=-1.0, b=0.5, sigma=0.7, df=0)
    if kind == "smoothbox_student_t":
        return _table(n, a=-1.0, b=0.5, sigma=0.7, df=2.5)
    if kind == "mixed":
        t = _table(n)
        t["mu"][0], t["sigma"][0], t["df"][0] = 0.1, 1.0, 0
        t["mu"][1], t["sigma"][1], t["df"][1] = 0.0, 2.0, 7.0
        t["a"][2], t["b"][2], t["sigma"][2], t["df"][2] = -5.0, -2.0, 0.5, 0
        t["a"][3], t["b"][3], t["sigma"][3], t["df"][3] = 0.0, 2.0, 0.4, 7.0
        return t
    raise KeyError(kind)


PRIOR_KINDS = ["uniform", "gaussian", "student_t", "student_t_df_nan",
               "smoothbox", "smoothbox_student_t", "mixed"]


@pytest.mark.parametrize("design", ["sobol", "rand", None])
@pytest.mark.parametrize("kind", PRIOR_KINDS)
def test_build_design_same_seed_same_design(design, kind):
    LB, UB, PLB, PUB = _box()
    hp = _priors(kind)
    x0 = np.array([[0.0, 0.5, -2.0, 1.0, 9.0], [-9.0, 0.0, 0.0, 0.0, 0.0]])
    np.random.seed(11)
    want = fj.build_design(x0, LB, UB, PLB, PUB, hp, 64, design)
    state_after = np.random.get_state()[1].copy()
    np.random.seed(11)
    got = ft.build_design(x0, LB, UB, PLB, PUB, hp, 64, design)
    assert got.shape == want.shape == (64, 5)
    assert np.max(np.abs(got - want)) <= ATOL
    # The global stream was advanced exactly as the JAX package does.
    assert np.array_equal(np.random.get_state()[1], state_after)
    # x0 rows come first, clipped into the box.
    assert np.array_equal(got[:2], np.clip(x0, LB, UB))
    assert np.all(got >= LB) and np.all(got <= UB)


@pytest.mark.parametrize("design", ["sobol", "rand"])
def test_build_design_fixed_and_half_open_dimensions(design):
    """A pinned dimension (LB == UB) stays pinned; a dimension without
    finite hard bounds spreads over its plausible box."""
    LB, UB, PLB, PUB = _box()
    LB[1] = UB[1] = PLB[1] = PUB[1] = 0.75
    LB[3], UB[3] = -np.inf, np.inf
    hp = _priors("uniform")
    x0 = np.zeros((1, 5))
    np.random.seed(5)
    want = fj.build_design(x0, LB, UB, PLB, PUB, hp, 33, design)
    np.random.seed(5)
    got = ft.build_design(x0, LB, UB, PLB, PUB, hp, 33, design)
    assert np.max(np.abs(got - want)) <= ATOL
    assert np.all(got[:, 1] == 0.75)
    assert np.all((got[1:, 3] >= PLB[3]) & (got[1:, 3] <= PUB[3]))


def test_build_design_explicit_rng_leaves_the_global_stream_alone():
    LB, UB, PLB, PUB = _box()
    hp = _priors("uniform")
    x0 = np.zeros((1, 5))
    np.random.seed(3)
    before = np.random.get_state()[1].copy()
    a = ft.build_design(x0, LB, UB, PLB, PUB, hp, 40, "sobol",
                        rng=np.random.default_rng(8))
    b = ft.build_design(x0, LB, UB, PLB, PUB, hp, 40, "sobol",
                        rng=np.random.default_rng(8))
    c = ft.build_design(x0, LB, UB, PLB, PUB, hp, 40, "rand",
                        rng=np.random.RandomState(8))
    assert np.array_equal(np.random.get_state()[1], before)
    assert np.array_equal(a, b) and a.shape == c.shape == (40, 5)
    assert np.all(c >= LB) and np.all(c <= UB)


def test_build_design_no_new_rows_and_bad_name():
    LB, UB, PLB, PUB = _box()
    hp = _priors("uniform")
    x0 = np.array([[0.0, 0.5, -2.0, 1.0, 9.0], [-9.0, 0.0, 0.0, 0.0, 0.0]])
    got = ft.build_design(x0, LB, UB, PLB, PUB, hp, 2)
    assert np.array_equal(got, fj.build_design(x0, LB, UB, PLB, PUB, hp, 2))
    with pytest.raises(ValueError, match="Unknown design"):
        ft.build_design(x0, LB, UB, PLB, PUB, hp, 8, "halton")


@pytest.mark.parametrize("batched", [True, False])
def test_f_min_fill_sorts_and_sends_failures_last(batched):
    LB, UB, PLB, PUB = _box(3)
    hp = _priors("gaussian", 3)
    x0 = np.zeros((1, 3))

    def f(x):
        return float(np.sum((x - 0.25) ** 2))

    def f_batch(X):
        v = np.sum((X - 0.25) ** 2, axis=1)
        v[::7] = np.nan  # failed factorizations
        return v

    kw = dict(f_batch=f_batch) if batched else {}
    np.random.seed(2)
    Xj, yj = fj.f_min_fill(f, x0, LB, UB, PLB, PUB, hp, 50, "sobol", **kw)
    np.random.seed(2)
    Xt, yt = ft.f_min_fill(f, x0, LB, UB, PLB, PUB, hp, 50, "sobol", **kw)
    assert np.max(np.abs(Xt - Xj)) <= ATOL
    assert np.array_equal(np.isinf(yt), np.isinf(yj))
    fin = np.isfinite(yj)
    assert np.max(np.abs(yt[fin] - yj[fin])) <= ATOL
    assert np.all(np.diff(yt[fin]) >= 0)
    if batched:
        assert np.sum(~fin) == 8 and np.all(~fin[-8:])


def test_f_min_fill_more_starts_than_points():
    LB, UB, PLB, PUB = _box(3)
    x0 = np.arange(12.0).reshape(4, 3) / 10
    X, y = ft.f_min_fill(lambda x: float(x[0]), x0, LB, UB, PLB, PUB,
                         _priors("uniform", 3), 2)
    assert X.shape == (2, 3) and np.array_equal(y, [0.0, 0.3])


Q = np.concatenate([[0.0, 1e-12, 1e-6], np.linspace(0.01, 0.99, 41),
                    [1 - 1e-6, 1 - 1e-12, 1.0]])


@pytest.mark.parametrize("sigma,a,b", [(0.7, -1.0, 0.5), (2.0, 0.0, 0.0),
                                        (0.05, -3.0, 8.0)])
def test_smoothbox_ppf(sigma, a, b):
    want = fj.smoothbox_ppf(Q, sigma, a, b)
    got = ft.smoothbox_ppf(Q, sigma, a, b)
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin])
    assert np.max(np.abs(got[fin] - want[fin])) <= ATOL
    # The quantile function inverts the CDF.
    mid = Q[3:-3]
    back = ft.smoothbox_cdf(ft.smoothbox_ppf(mid, sigma, a, b), sigma, a, b)
    assert np.max(np.abs(back - mid)) < 1e-10
    assert isinstance(ft.smoothbox_ppf(0.3, sigma, a, b), float)


@pytest.mark.parametrize("df,sigma,a,b", [(3.0, 0.7, -1.0, 0.5),
                                           (1.0, 2.0, 0.0, 0.0),
                                           (7.0, 0.05, -3.0, 8.0)])
def test_smoothbox_student_t_ppf(df, sigma, a, b):
    want = fj.smoothbox_student_t_ppf(Q, df, sigma, a, b)
    got = ft.smoothbox_student_t_ppf(Q, df, sigma, a, b)
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin])
    assert np.max(np.abs(got[fin] - want[fin]) / np.maximum(1, np.abs(want[fin]))) <= ATOL
    mid = Q[3:-3]
    back = ft.smoothbox_student_t_cdf(
        ft.smoothbox_student_t_ppf(mid, df, sigma, a, b), df, sigma, a, b)
    assert np.max(np.abs(back - mid)) < 1e-10
    assert isinstance(ft.smoothbox_student_t_ppf(0.3, df, sigma, a, b), float)


@pytest.mark.parametrize("B,w", [
    ((-2.0, -1.0, 1.0, 3.0), 0.5),
    ((-2.0, -1.0, 1.0, 3.0), 1.0),
    ((-2.0, -1.0, 1.0, 3.0), 0.0),
    ((-1.0, -1.0, 1.0, 1.0), 0.6),   # point outer intervals: two deltas
    ((-1.0, -1.0, 1.0, 1.0), 0.0),
    ((-2.0, -2.0, 1.0, 3.0), 0.3),   # one outer interval of zero length
])
def test_uuinv(B, w):
    p = np.concatenate([[-0.1, 0.0], np.linspace(0.001, 0.999, 57), [1.0, 1.1]])
    want = fj.uuinv(p, B, w)
    got = ft.uuinv(p, B, w)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.max(np.abs(got[ok] - want[ok])) <= ATOL
