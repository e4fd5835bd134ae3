"""The port's MALA chain (``gpyreg_tpu_torch.inference.mala``) against the
JAX package's (``gpyreg_tpu.inference.mala``) on the CPU, in float64.

Under the replay of the JAX key tree (``tests/torch_replay.py``) the
port's ``sample`` draws the JAX chain's normals and uniforms, so the two
chains are one chain: samples, f_vals, log_priors, accept_rate, R and
eff_N agree to 1e-8 relative, the chains move at the same steps, and the
exit flags are equal.  The densities are the GP's ``log_post_raw`` with a
hyperprior (N = 48, D = 2) and a 3-D Gaussian with one dimension fixed by
its bounds; the cases cover the default widths, step size and burn-in, a
given preconditioner and step size, thinning, an additive log prior, no
burn-in, infinite bounds, and a box so tight that many proposals fall
outside it (the port makes no call for those; JAX evaluates and masks
them).
"""

import jax
import numpy as np
import pytest
import torch

import gpyreg_tpu.inference.mala as JM
from gpyreg_tpu_torch.inference import mala as TM
from torch_replay import replay
from torch_sampler_cases import (GP_LB, GP_UB, GP_WIDTHS, GP_X0, LB3, SEED, UB3,
                                 X0, check, gauss, gp_density, moved)

torch.set_num_threads(1)

TIGHT_LB, TIGHT_UB = [-0.2, 0.2, 0.1], [0.6, 0.2, 1.5]
CASES = {
    "defaults": dict(n_samples=30, LB=LB3, UB=UB3),
    "fixed_dim_welford": dict(n_samples=40, burn=30, LB=LB3, UB=UB3),
    "widths_step_thin_prior": dict(n_samples=15, burn=20, thin=3, widths=1.0,
                                   step_size=0.9, LB=LB3, UB=UB3, prior=True),
    "no_burn": dict(n_samples=40, burn=0, LB=LB3, UB=UB3),
    "infinite_bounds": dict(n_samples=40, burn=20, widths=[0.5, 1.0, 2.0],
                            step_size=0.8),
    "tight_box": dict(n_samples=40, burn=20, widths=1.0, LB=TIGHT_LB,
                      UB=TIGHT_UB),
}


class _Counted:
    """A density that counts its calls."""

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
    rj, xj = JM.sample(fj, X0, jax.random.key(SEED), log_prior=pj, **kw)
    counted = _Counted(ft)
    rt, xt = TM.sample(counted, X0, replay(SEED), log_prior=pt, **kw)
    return rt, xt, rj, xj, counted.n


@pytest.fixture(scope="module")
def runs():
    out = {name: _run(case) for name, case in CASES.items()}
    fj, aj = gp_density("jax")
    ft, at = gp_density("torch")
    kw = dict(n_samples=30, burn=20, widths=GP_WIDTHS, LB=GP_LB, UB=GP_UB)
    rj, xj = JM.sample(fj["log_post_raw"], GP_X0, jax.random.key(SEED),
                       f_args=aj, log_prior=fj["log_prior_raw"], **kw)
    counted = _Counted(ft["log_post_raw"])
    rt, xt = TM.sample(counted, GP_X0, replay(SEED), f_args=at,
                       log_prior=ft["log_prior_raw"], **kw)
    out["gp"] = (rt, xt, rj, xj, counted.n)
    return out


@pytest.mark.parametrize("name", sorted(CASES) + ["gp"])
def test_chain_equals_the_jax_chain(name, runs):
    rt, xt, rj, xj, _ = runs[name]
    check(rt, rj)
    assert np.array_equal(moved(rt["samples"]), moved(rj["samples"]))
    assert np.max(np.abs(xt - np.asarray(xj))) <= 1e-8 * max(1.0, np.max(np.abs(xj)))
    n = CASES[name]["n_samples"] if name in CASES else 30
    assert rt["samples"].shape == (n, xt.shape[0]) and rt["f_vals"].shape == (n, 1)
    assert 0.0 <= rt["accept_rate"] <= 1.0


@pytest.mark.parametrize("name", ["defaults", "fixed_dim_welford", "tight_box"])
def test_fixed_dimension_stays_pinned_inside_the_bounds(name, runs):
    s = runs[name][0]["samples"]
    lb, ub = np.asarray(CASES[name]["LB"]), np.asarray(CASES[name]["UB"])
    assert np.all(s >= lb) and np.all(s <= ub)
    assert np.all(s[:, 1] == 0.2)


def test_log_prior_is_split_out_of_the_values(runs):
    rt = runs["widths_step_thin_prior"][0]
    _, p = gauss("torch", prior=True)
    want = [float(p(torch.tensor(s))) for s in rt["samples"]]
    assert np.allclose(rt["log_priors"], want, rtol=1e-12, atol=0)
    assert np.all(rt["log_priors"] < 0)


def test_one_call_a_step_and_none_outside_the_box(runs):
    """Each step calls the density once where its proposal lies in the
    box (and the start once): the GP chain, whose box holds every
    proposal, makes exactly one call a step; in the tight box the chain
    skips the proposals outside it."""
    _, _, _, _, n_gp = runs["gp"]
    assert n_gp == 1 + 20 + 30
    _, _, _, _, n_tight = runs["tight_box"]
    assert 1 < n_tight < 1 + 20 + 40


def test_start_outside_the_bounds_raises_as_jax():
    f, _ = gauss("torch")
    kw = dict(n_samples=5, LB=LB3, UB=UB3)
    with pytest.raises(ValueError) as ej:
        JM.sample(gauss("jax")[0], X0 + 10.0, jax.random.key(0), **kw)
    with pytest.raises(ValueError, match="outside the bounds") as et:
        TM.sample(f, X0 + 10.0, replay(0), **kw)
    assert str(et.value) == str(ej.value)


def test_non_finite_start_raises_as_jax():
    kw = dict(n_samples=5, burn=2)
    with pytest.raises(ValueError) as ej:
        JM.sample(lambda x: jax.numpy.sum(x) * np.nan, X0, jax.random.key(0), **kw)
    with pytest.raises(ValueError, match="real number") as et:
        TM.sample(lambda x: torch.sum(x) * np.nan, X0, replay(0), **kw)
    assert str(et.value) == str(ej.value)


def test_integer_seed_runs_without_a_replay():
    """The default stream (a ``torch.Generator`` seeded by the integer)
    gives a repeatable chain inside the bounds."""
    f, _ = gauss("torch")
    a, _ = TM.sample(f, X0, 5, n_samples=20, LB=LB3, UB=UB3)
    b, _ = TM.sample(f, X0, 5, n_samples=20, LB=LB3, UB=UB3)
    assert np.array_equal(a["samples"], b["samples"])
    assert np.all(a["samples"] >= LB3) and np.all(a["samples"] <= UB3)


def test_flat_density_in_a_box_equals_the_jax_chain():
    """A density that does not depend on x (no gradient to take): a
    uniform on [0, 1], where only the bounds reject."""
    kw = dict(n_samples=40, burn=10, LB=np.array([0.0]), UB=np.array([1.0]))
    rj, _ = JM.sample(lambda x: jax.numpy.asarray(0.0), np.array([0.5]),
                      jax.random.key(SEED), **kw)
    rt, _ = TM.sample(lambda x: torch.tensor(0.0), np.array([0.5]),
                      replay(SEED), **kw)
    check(rt, rj)
    assert np.all((rt["samples"] >= 0.0) & (rt["samples"] <= 1.0))
