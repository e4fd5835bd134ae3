"""The port's hyperprior (``core/priors.py``), its smoothbox CDFs
(``f_min_fill.py``) and the GP's truncation constants against the JAX
package, in float64: each of the four families, fixed hyperparameters
(-inf off the pinned value) and improper-uniform ones, value and
gradient at 1e-8 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gpyreg_tpu as gj
from gpyreg_tpu import f_min_fill as FJ
from gpyreg_tpu.core import priors as PJ
import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch import f_min_fill as FT
from gpyreg_tpu_torch.core import priors as PT
from gpyreg_tpu_torch.core.nlml import value_and_grad

torch.set_num_threads(1)

RTOL = 1e-8
H = 6  # hyperparameters of the table tests
FAMILIES = ("gaussian", "student_t", "smoothbox", "smoothbox_student_t")


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _table(family, rng):
    """One family on hyperparameters 0-3, nothing (improper uniform) on
    4-5; bounds finite on 0-4."""
    t = {k: np.full((H,), np.nan) for k in ("mu", "sigma", "df", "a", "b")}
    i = slice(0, 4)
    t["sigma"][i] = rng.uniform(0.5, 2.0, size=4)
    t["df"][i] = 0.0
    if family in ("gaussian", "student_t"):
        t["mu"][i] = rng.normal(size=4)
    else:
        t["a"][i] = rng.uniform(-2.0, -0.5, size=4)
        t["b"][i] = rng.uniform(0.5, 2.0, size=4)
    if family.endswith("student_t"):
        t["df"][i] = rng.uniform(2.0, 7.0, size=4)
    lb = np.array([-4.0, -3.0, -np.inf, -5.0, -6.0, -np.inf])
    ub = np.array([4.0, np.inf, 3.0, 5.0, 6.0, np.inf])
    return t, lb, ub


@pytest.mark.parametrize("family", FAMILIES)
def test_log_prior_value_and_gradient_match_jax(family):
    rng = np.random.default_rng(FAMILIES.index(family))
    table, lb, ub = _table(family, rng)
    pack_t = PT.build_prior_pack(table, lb, ub, log_norm=0.25)
    pack_j = PJ.build_prior_pack(table, lb, ub, log_norm=0.25)
    # Points inside the box, on its flanks, and beyond the bounds.
    for hyp in (rng.normal(size=H), 3.0 * rng.normal(size=H)):
        v_t, g_t = value_and_grad(lambda h: PT.log_prior(pack_t, h),
                                  hyp, torch.zeros(1))
        v_j, g_j = jax.value_and_grad(lambda h: PJ.log_prior(pack_j, h))(
            jnp.asarray(hyp))
        assert np.isfinite(v_t.item())
        assert _rel(v_t.item(), v_j) < RTOL
        assert _rel(g_t.numpy(), g_j) < RTOL
        assert np.all(g_t[4:].numpy() == 0.0)  # improper uniform


def test_fixed_hyperparameter_pins_the_prior():
    table, lb, ub = _table("gaussian", np.random.default_rng(7))
    lb[5] = ub[5] = 0.5
    pack_t = PT.build_prior_pack(table, lb, ub)
    pack_j = PJ.build_prior_pack(table, lb, ub)
    hyp = np.zeros(H)
    hyp[5] = 0.5
    on = PT.log_prior(pack_t, torch.as_tensor(hyp))
    assert _rel(on.item(), PJ.log_prior(pack_j, jnp.asarray(hyp))) < RTOL
    hyp[5] = 0.6
    off = PT.log_prior(pack_t, torch.as_tensor(hyp))
    assert off.item() == -np.inf
    assert float(PJ.log_prior(pack_j, jnp.asarray(hyp))) == -np.inf


def test_smoothbox_cdfs_match_jax():
    x = np.linspace(-5.0, 5.0, 41)
    assert _rel(FT.smoothbox_cdf(x, 0.7, -1.0, 1.5),
                FJ.smoothbox_cdf(x, 0.7, -1.0, 1.5)) < 1e-14
    assert _rel(FT.smoothbox_student_t_cdf(x, 3.0, 0.7, -1.0, 1.5),
                FJ.smoothbox_student_t_cdf(x, 3.0, 0.7, -1.0, 1.5)) < 1e-14
    assert isinstance(FT.smoothbox_cdf(0.3, 0.7, -1.0, 1.5), float)


def _gp_pair(D=2):
    args = lambda m: (D, m.covariance_functions.SquaredExponential(),  # noqa: E731
                      m.mean_functions.ConstantMean(),
                      m.noise_functions.GaussianNoise(constant_add=True))
    return gj.GP(*args(gj)), gt.GP(*args(gt), device="cpu")


PRIOR_SETS = {
    "gaussian": {"covariance_log_lengthscale": ("gaussian", (0.1, 1.5)),
                 "covariance_log_outputscale": ("gaussian", (0.0, 2.0)),
                 "noise_log_scale": ("gaussian", (-2.0, 1.0)),
                 "mean_const": None},
    "student_t": {"covariance_log_lengthscale": ("student_t", (0.1, 1.5, 3.0)),
                  "covariance_log_outputscale": None,
                  "noise_log_scale": ("student_t", (-2.0, 1.0, 5.0)),
                  "mean_const": ("gaussian", (0.0, 3.0))},
    "smoothbox": {"covariance_log_lengthscale": ("smoothbox", (-1.0, 1.0, 0.5)),
                  "covariance_log_outputscale": ("smoothbox", (-2.0, 2.0, 1.0)),
                  "noise_log_scale": None,
                  "mean_const": None},
    "smoothbox_student_t": {
        "covariance_log_lengthscale": ("smoothbox_student_t", (-1.0, 1.0, 0.5, 4.0)),
        "covariance_log_outputscale": None,
        "noise_log_scale": ("smoothbox_student_t", (-4.0, 0.0, 1.0, 3.0)),
        "mean_const": ("student_t", (0.0, 1.0, 2.5))},
}
BOUNDS = {"covariance_log_lengthscale": (-2.0, 2.5),
          "covariance_log_outputscale": (-3.0, np.inf),
          "noise_log_scale": (-np.inf, 0.5),
          "mean_const": (-1.0, 1.0)}


@pytest.mark.parametrize("name", sorted(PRIOR_SETS))
def test_normalization_constants_match_jax(name):
    """``set_priors`` then ``set_bounds`` (and the reverse order)
    recompute the truncation constants as the JAX GP does."""
    gjp, gtp = _gp_pair()
    for g in (gjp, gtp):
        g.set_priors(PRIOR_SETS[name])
        g.set_bounds(BOUNDS)
    assert gtp.no_prior is False
    assert np.all(gtp.normalization_constants < 1.0 + 1e-15)
    assert _rel(gtp.normalization_constants, gjp.normalization_constants) < 1e-14
    for g in (gjp, gtp):
        g.set_bounds(None)
    assert np.all(gtp.normalization_constants == 1.0)
    assert np.array_equal(gtp.normalization_constants,
                          gjp.normalization_constants)
    for g in (gjp, gtp):
        g.set_priors(None)
    assert gtp.no_prior is True and gjp.no_prior is True
