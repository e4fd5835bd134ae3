"""The port's HMC chain (``gpyreg_tpu_torch.inference.hmc``) against the
JAX package's (``gpyreg_tpu.inference.hmc``) on the CPU, in float64.

Under the replay of the JAX key tree (``tests/torch_replay.py``) the
port's ``sample`` draws the JAX chain's momenta, step jitters and
acceptance uniforms, so the two chains are one chain: samples, f_vals,
log_priors, accept_rate, R and eff_N agree to 1e-8 relative, the chains
move at the same iterations, and the exit flags are equal.  The
densities are the GP's ``log_post_raw`` with a hyperprior (N = 48, D = 2)
and a 3-D Gaussian with one dimension fixed by its bounds, with 3 and 10
leapfrog steps.

A leapfrog point outside the box is -inf with the density's own finite
gradient in both packages (the JAX code's ``_masked_value_and_grad``), so
trajectories that leave the box and turn back into it are the same
chain too (``test_a_trajectory_that_leaves_the_box_equals_the_jax_chain``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyreg_tpu.inference.hmc as JH
from gpyreg_tpu_torch.inference import hmc as TH
from torch_replay import replay
from torch_sampler_cases import (GP_LB, GP_UB, GP_WIDTHS, GP_X0, LB3, SEED, UB3,
                                 X0, check, gauss, gp_density, moved)

torch.set_num_threads(1)

CASES = {
    "defaults_leap10": dict(n_samples=30, LB=LB3, UB=UB3),
    "welford_leap3": dict(n_samples=30, burn=25, n_leapfrog=3, LB=LB3, UB=UB3),
    "widths_step_thin_prior": dict(n_samples=12, burn=20, thin=3, widths=1.0,
                                   step_size=0.3, n_leapfrog=3, LB=LB3,
                                   UB=UB3, prior=True),
    "no_burn_leap10": dict(n_samples=30, burn=0, step_size=0.2, LB=LB3, UB=UB3),
    "infinite_bounds_leap3": dict(n_samples=30, burn=20, n_leapfrog=3,
                                  widths=[0.5, 1.0, 2.0], step_size=0.5),
}


class _Counted:
    def __init__(self, f):
        self.f, self.n = f, 0

    def __call__(self, x, *args):
        self.n += 1
        return self.f(x, *args)


def _run(case):
    kw = dict(case)
    prior = kw.pop("prior", False)
    fj, pj = gauss("jax", prior)
    ft, pt = gauss("torch", prior)
    rj, xj = JH.sample(fj, X0, jax.random.key(SEED), log_prior=pj, **kw)
    rt, xt = TH.sample(ft, X0, replay(SEED), log_prior=pt, **kw)
    return rt, xt, rj, xj


@pytest.fixture(scope="module")
def runs():
    out = {name: _run(case) for name, case in CASES.items()}
    fj, aj = gp_density("jax")
    ft, at = gp_density("torch")
    kw = dict(n_samples=20, burn=20, widths=GP_WIDTHS, LB=GP_LB, UB=GP_UB,
              n_leapfrog=3)
    rj, xj = JH.sample(fj["log_post_raw"], GP_X0, jax.random.key(SEED),
                       f_args=aj, log_prior=fj["log_prior_raw"], **kw)
    counted = _Counted(ft["log_post_raw"])
    rt, xt = TH.sample(counted, GP_X0, replay(SEED), f_args=at,
                       log_prior=ft["log_prior_raw"], **kw)
    out["gp_leap3"] = (rt, xt, rj, xj)
    out["gp_calls"] = counted.n
    return out


@pytest.mark.parametrize("name", sorted(CASES) + ["gp_leap3"])
def test_chain_equals_the_jax_chain(name, runs):
    rt, xt, rj, xj = runs[name]
    check(rt, rj)
    assert np.array_equal(moved(rt["samples"]), moved(rj["samples"]))
    assert np.max(np.abs(xt - np.asarray(xj))) <= 1e-8 * max(1.0, np.max(np.abs(xj)))
    n = CASES[name]["n_samples"] if name in CASES else 20
    assert rt["samples"].shape == (n, xt.shape[0])
    assert 0.0 <= rt["accept_rate"] <= 1.0


@pytest.mark.parametrize("name", ["defaults_leap10", "welford_leap3"])
def test_fixed_dimension_stays_pinned_inside_the_bounds(name, runs):
    s = runs[name][0]["samples"]
    assert np.all(s >= LB3) and np.all(s <= UB3) and np.all(s[:, 1] == 0.2)


def test_one_call_a_leapfrog_point(runs):
    """The start and every leapfrog point of the GP chain (its box holds
    every point) make one value-and-gradient call each."""
    assert runs["gp_calls"] == 1 + (20 + 20) * 3


def test_a_trajectory_that_leaves_the_box_equals_the_jax_chain():
    """A standard normal cut at -0.3: with long trajectories most leave
    the box.  The density's gradient outside the box turns them back, and
    the JAX chain accepts most of them; the port's chain is that chain."""
    LB, UB = np.array([-0.3, -0.3]), np.array([4.0, 4.0])
    kw = dict(n_samples=30, burn=0, widths=1.0, LB=LB, UB=UB, step_size=0.6,
              n_leapfrog=10, diagnostics=False)
    x0 = np.array([0.5, 0.5])
    rj, xj = JH.sample(lambda x: -0.5 * jnp.sum(x**2), x0, jax.random.key(3),
                       **kw)
    rt, xt = TH.sample(lambda x: -0.5 * torch.sum(x**2), x0, replay(3), **kw)
    assert rj["accept_rate"] > 0.5
    check(rt, rj)
    assert np.array_equal(moved(rt["samples"]), moved(rj["samples"]))
    assert np.max(np.abs(xt - np.asarray(xj))) <= 1e-8


def test_start_outside_the_bounds_raises_as_jax():
    kw = dict(n_samples=5, LB=LB3, UB=UB3)
    with pytest.raises(ValueError) as ej:
        JH.sample(gauss("jax")[0], X0 - 10.0, jax.random.key(0), **kw)
    with pytest.raises(ValueError, match="outside the bounds") as et:
        TH.sample(gauss("torch")[0], X0 - 10.0, replay(0), **kw)
    assert str(et.value) == str(ej.value)


def test_non_finite_start_raises_as_jax():
    kw = dict(n_samples=5, burn=2, n_leapfrog=3)
    with pytest.raises(ValueError) as ej:
        JH.sample(lambda x: -jnp.inf + jnp.sum(x), X0, jax.random.key(0), **kw)
    with pytest.raises(ValueError, match="real number") as et:
        TH.sample(lambda x: -np.inf + torch.sum(x), X0, replay(0), **kw)
    assert str(et.value) == str(ej.value)


def test_integer_seed_runs_without_a_replay():
    f, _ = gauss("torch")
    a, _ = TH.sample(f, X0, 5, n_samples=20, n_leapfrog=3, LB=LB3, UB=UB3)
    b, _ = TH.sample(f, X0, 5, n_samples=20, n_leapfrog=3, LB=LB3, UB=UB3)
    assert np.array_equal(a["samples"], b["samples"])
    assert np.all(a["samples"] >= LB3) and np.all(a["samples"] <= UB3)
