"""The rest of the port's ``GP`` surface against the JAX package's on the
CPU, in float64: ``fmin``, ``plot``, ``str``/``repr``, the
``gaussian_process`` alias and the package's exports.

``fmin`` draws its random starts from numpy's global stream as the JAX
package does, so under one ``np.random.seed`` both start from the same
points, and the optima agree within 1e-6 in x and in fval.  ``plot``
runs on matplotlib's Agg backend: the same axes as JAX's, and every
line's ydata within 1e-8 relative.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import gpyreg_tpu as gj  # noqa: E402
import gpyreg_tpu.inference.map_optimize as JM  # noqa: E402
import gpyreg_tpu_torch as gt  # noqa: E402
import gpyreg_tpu_torch.inference.map_optimize as TM  # noqa: E402
from gpyreg_tpu_torch.ops import tile_kernels as TK  # noqa: E402
from torch_serving_cases import RTOL, make, pair, rel  # noqa: E402

torch.set_num_threads(1)


def _bowl_pair(D=2, seed=1):
    """Both packages' GP on noisy data of -|x - 1|^2 with fixed
    hyperparameters (2 samples)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (30, D))
    y = -np.sum((X - 1) ** 2, 1, keepdims=True) + 0.1 * rng.normal(size=(30, 1))
    g, t = make(gj, D), make(gt, D)
    hyp = np.concatenate([np.log(np.full(D, 2.0)), [np.log(5.0)], [-2.0], [0.0]])
    hyp = np.stack([hyp, hyp + 0.05 * rng.normal(size=hyp.shape)])
    for m in (g, t):
        m.update(X_new=X, y_new=y, hyp=hyp)
    return g, t


def _record_starts(monkeypatch, module):
    seen = []
    inner = module.multistart_map

    def spy(obj, starts, *args, **kw):
        seen.append(np.array(starts))
        return inner(obj, starts, *args, **kw)

    monkeypatch.setattr(module, "multistart_map", spy)
    return seen


@pytest.mark.parametrize("x0", [False, True])
@pytest.mark.parametrize("max_flag", [False, True])
def test_fmin_matches_jax(monkeypatch, max_flag, x0):
    g, t = _bowl_pair()
    seen_j = _record_starts(monkeypatch, JM)
    seen_t = _record_starts(monkeypatch, TM)
    start = np.array([0.5, 0.5]) if x0 else None
    np.random.seed(4)
    xj, fj = g.fmin(x0=start, max_flag=max_flag)
    np.random.seed(4)
    xt, ft = t.fmin(x0=start, max_flag=max_flag)
    assert np.array_equal(seen_t[0], seen_j[0])
    assert seen_t[0].shape[0] == 3
    assert xt.shape == (2,) and isinstance(ft, float)
    assert np.max(np.abs(xt - xj)) < 1e-6 and abs(ft - fj) < 1e-6
    # fval is the mixture mean at x.
    mu, _ = t.predict(xt[None, :])
    assert abs(mu[0, 0] - ft) < 1e-10


def test_fmin_objective_takes_the_plain_composition():
    """The objective differentiates the mean in x: it asks for the plain
    composition, never the kernel tile, so no tile launch is counted."""
    _, t = _bowl_pair()
    TK.reset_launches()
    np.random.seed(0)
    t.fmin()
    assert not any(TK.LAUNCHES.values())
    f = t._mixture_mean_variance_fn(compute_var=False, differentiable=True)
    x = torch.tensor([0.2, -0.1], dtype=torch.float64, requires_grad=True)
    mu, s2 = f(x)
    (g,) = torch.autograd.grad(mu, x)
    eps = 1e-6
    fd = [(float(f(x.detach() + eps * e)[0]) - float(f(x.detach() - eps * e)[0]))
          / (2 * eps) for e in torch.eye(2, dtype=torch.float64)]
    assert s2 is None and np.allclose(g.numpy(), fd, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="mean alone"):
        t._mixture_mean_variance_fn(differentiable=True)


def _plot_pair(D):
    """The GP of tests/test_plot.py in both packages."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (25, D))
    y = np.sin(np.sum(X, axis=1, keepdims=True)) + 0.1 * rng.normal(size=(25, 1))
    hyp = np.concatenate([np.zeros(D), [0.0], [-2.0], [0.0]])[None, :]
    out = []
    for pkg in (gj, gt):
        gp = make(pkg, D)
        gp.update(X_new=X, y_new=y, hyp=hyp)
        out.append(gp)
    return out


def _lines(fig):
    return [[np.asarray(line.get_ydata(), dtype=np.float64)
             for line in ax.get_lines()] for ax in fig.axes]


@pytest.mark.parametrize("kw", [{}, {"delta_y": 2.0}])
@pytest.mark.parametrize("D", [1, 2])
def test_plot_matches_jax(D, kw):
    g, t = _plot_pair(D)
    fig_j = g.plot(**kw)
    lines_j = _lines(fig_j)
    n_axes_j = len(fig_j.axes)
    plt.close("all")
    fig_t = t.plot(**kw)
    lines_t = _lines(fig_t)
    assert len(fig_t.axes) == n_axes_j == D * D
    assert [len(a) for a in lines_t] == [len(a) for a in lines_j]
    for ax_t, ax_j in zip(lines_t, lines_j):
        for yt, yj in zip(ax_t, ax_j):
            assert yt.shape == yj.shape and rel(yt, yj) < RTOL
    for a_t, a_j in zip(fig_t.axes, fig_j.axes):
        assert np.allclose(a_t.get_xlim(), a_j.get_xlim(), rtol=RTOL)
    plt.close("all")


def _str_pair(cov, noise_kw, prior):
    out = []
    for pkg in (gj, gt):
        c = (pkg.covariance_functions.Matern(3) if cov == "m3"
             else pkg.covariance_functions.SquaredExponential())
        gp = pkg.GP(3, c, pkg.mean_functions.NegativeQuadratic(),
                    pkg.noise_functions.GaussianNoise(**noise_kw),
                    **({} if pkg is gj else {"device": "cpu"}))
        if prior:
            gp.set_priors({name: ("gaussian", (0.0, 1.0)) if k == 0 else None
                           for k, (name, _) in enumerate(gp._hyper_info())})
        out.append(gp)
    return out


@pytest.mark.parametrize("case", [
    ("se", {"constant_add": True}, False),
    ("m3", {"constant_add": True, "user_provided_add": True,
            "rectified_linear_output_dependent_add": True}, True),
])
def test_str_matches_jax(case):
    g, t = _str_pair(*case)
    assert str(t) == str(g)
    rng = np.random.default_rng(0)
    hyp = rng.normal(size=(2, g._hyp_N()))
    g.update(hyp=hyp)
    t.update(hyp=hyp)
    assert str(t) == str(g)
    assert "Hyperparameter samples: 2" in str(t)


def test_repr_lists_the_model_as_jax_does():
    g, t, _ = pair((-2.3, -2.2), N=12)
    rj, rt = repr(g).splitlines(), repr(t).splitlines()
    assert rt[0] == rj[0] == "GP:"
    for key in ("D", "X", "y", "s2", "lower_bounds", "upper_bounds"):
        line = f"    self.{key} = "
        mine = [r for r in rt if r.startswith(line)]
        assert mine and mine == [r for r in rj if r.startswith(line)], key
    order = [r.split(" = ")[0].strip() for r in rt if r.startswith("    self.")]
    assert order[:10] == [f"self.{k}" for k in (
        "D", "covariance", "mean", "noise", "X", "y", "s2", "lower_bounds",
        "upper_bounds", "posteriors")]
    assert "self._ctx" not in order and "self._fit_ctx" not in order


def test_alias_module_and_exports():
    from gpyreg_tpu_torch import gaussian_process
    from gpyreg_tpu_torch import f_min_fill, slice_sample

    assert gaussian_process.GP is gt.GP
    assert gaussian_process.Posterior is gt.Posterior
    assert gt.f_min_fill is f_min_fill and gt.slice_sample is slice_sample
    assert set(gt.__all__) == set(gj.__all__)
    for name in gt.__all__:
        assert hasattr(gt, name)
