"""The port's ensemble slice chain
(``gpyreg_tpu_torch.inference.ensemble_slice``) against the JAX
package's (``gpyreg_tpu.inference.ensemble_slice``) on the CPU, in
float64.

Under the replay of the JAX key tree (``tests/torch_replay.py``) the
port draws the JAX chain's fill, walker pairs and slice uniforms; its
walkers move one after the other where the JAX package moves a half in
one ``vmap``, which is the same chain: samples, f_vals, log_priors, R and
eff_N agree to 1e-8 relative, the final walkers too, and the exit flags
are equal.  The densities are the GP's ``log_post_chain_raw`` with a
hyperprior (N = 48, D = 2) and a 3-D Gaussian with one dimension fixed by
its bounds; the cases cover the default ensemble from one point, stacks
of starts shorter and longer than the ensemble, an odd and a too small
``n_walkers``, thinning, an additive log prior, infinite bounds and the
shrink-cap exit.  ``diagnose_ensemble`` is held to JAX's on histories of
one iteration and of many.
"""

import jax
import numpy as np
import pytest
import torch

import gpyreg_tpu.inference.ensemble_slice as JE
from gpyreg_tpu_torch.inference import ensemble_slice as TE
from torch_replay import replay
from torch_sampler_cases import (GP_LB, GP_UB, GP_WIDTHS, GP_X0, LB3, SEED, UB3,
                                 X0, check, gauss, gp_density)

torch.set_num_threads(1)

_rng = np.random.default_rng(2)
STACK3 = np.clip(X0 + 0.3 * _rng.normal(size=(3, 3)), LB3, UB3)
STACK10 = np.clip(X0 + 0.3 * _rng.normal(size=(10, 3)), LB3, UB3)
CASES = {
    # (x0, options, walkers K)
    "defaults_one_point": (X0, dict(n_samples=40, LB=LB3, UB=UB3), 8),
    "stack_fill_odd_walkers_thin_prior": (
        STACK3, dict(n_samples=20, n_walkers=5, thin=2, burn=3, LB=LB3, UB=UB3,
                     prior=True), 6),
    "stack_longer_than_ensemble": (STACK10, dict(n_samples=16, burn=2, LB=LB3,
                                                 UB=UB3), 8),
    "too_few_walkers_infinite_bounds": (X0, dict(n_samples=12, n_walkers=2,
                                                 burn=3), 4),
    "shrink_cap": (X0, dict(n_samples=16, burn=2, max_shrink=2,
                            sigma_factor=20.0, LB=LB3, UB=UB3), 8),
}


def _run(x0, case):
    kw = dict(case)
    prior = kw.pop("prior", False)
    fj, pj = gauss("jax", prior)
    ft, pt = gauss("torch", prior)
    rj, wj = JE.sample(fj, x0, jax.random.key(SEED), log_prior=pj, **kw)
    rt, wt = TE.sample(ft, x0, replay(SEED), log_prior=pt, **kw)
    return rt, wt, rj, wj


@pytest.fixture(scope="module")
def runs():
    out = {name: _run(x0, case) for name, (x0, case, _) in CASES.items()}
    fj, aj = gp_density("jax")
    ft, at = gp_density("torch")
    kw = dict(n_samples=24, burn=2, widths=GP_WIDTHS, LB=GP_LB, UB=GP_UB)
    rj, wj = JE.sample(fj["log_post_chain_raw"], GP_X0, jax.random.key(SEED),
                       f_args=aj, log_prior=fj["log_prior_raw"], **kw)
    rt, wt = TE.sample(ft["log_post_chain_raw"], GP_X0, replay(SEED),
                       f_args=at, log_prior=ft["log_prior_raw"], **kw)
    out["gp"] = (rt, wt, rj, wj)
    return out


@pytest.mark.parametrize("name", sorted(CASES) + ["gp"])
def test_chain_equals_the_jax_chain(name, runs):
    rt, wt, rj, wj = runs[name]
    check(rt, rj)
    wj = np.asarray(wj)
    assert wt.shape == wj.shape
    assert np.max(np.abs(wt - wj)) <= 1e-8 * max(1.0, np.max(np.abs(wj)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_walker_count_and_bounds(name, runs):
    x0, case, K = CASES[name]
    rt, wt, _, _ = runs[name]
    assert wt.shape == (K, 3)
    assert rt["samples"].shape == (case["n_samples"], 3)
    lb = case.get("LB", -np.inf)
    ub = case.get("UB", np.inf)
    assert np.all(rt["samples"] >= lb) and np.all(rt["samples"] <= ub)
    if "LB" in case:
        assert np.all(rt["samples"][:, 1] == 0.2)


def test_the_fill_keeps_the_given_walkers():
    """The ensemble's first rows are the given starts; the fill jitters
    copies of them (the JAX fill, replayed) and clips to the bounds: with
    a chain of no iteration the walkers returned are the ensemble."""
    f, _ = gauss("torch")
    _, ens = TE.sample(f, STACK3, replay(SEED), n_samples=0, burn=1,
                       n_walkers=6, LB=LB3, UB=UB3, diagnostics=False)
    key, k_fill = jax.random.split(jax.random.key(SEED))
    w = (UB3 - LB3) / 2.0
    fill = STACK3 + 0.1 * w * np.asarray(jax.random.normal(k_fill, (3, 3)))
    _, ens_j = JE.sample(gauss("jax")[0], STACK3, jax.random.key(SEED),
                         n_samples=0, burn=1, n_walkers=6, LB=LB3, UB=UB3,
                         diagnostics=False)
    assert np.max(np.abs(ens - np.asarray(ens_j))) <= 1e-12
    assert ens.shape == (6, 3)
    assert not np.allclose(ens[3:], np.clip(fill, LB3, UB3))  # one move made


@pytest.mark.parametrize("n_iters,K,n_req", [(1, 6, 10), (2, 4, 8), (20, 6, 10),
                                             (20, 6, 1000), (3, 4, 2)])
def test_diagnose_ensemble_equals_jax(n_iters, K, n_req):
    rng = np.random.default_rng(n_iters * 100 + K)
    hist = np.cumsum(rng.normal(size=(n_iters, K, 3)), axis=0) * [1.0, 0.1, 3.0]
    ft, Rt, et = TE.diagnose_ensemble(hist, n_req)
    fj, Rj, ej = JE.diagnose_ensemble(hist, n_req)
    assert ft == fj
    if n_iters < 2:
        assert (ft, Rt, et) == (0, None, None) and Rj is None
        return
    assert np.allclose(Rt, Rj, rtol=1e-12, atol=0)
    assert np.allclose(et, ej, rtol=1e-12, atol=0) and np.all(et > 0)


def test_start_outside_the_bounds_raises_as_jax():
    kw = dict(n_samples=5, LB=LB3, UB=UB3)
    x0 = np.vstack([X0, X0 + 10.0])
    with pytest.raises(ValueError) as ej:
        JE.sample(gauss("jax")[0], x0, jax.random.key(0), **kw)
    with pytest.raises(ValueError, match="outside the bounds") as et:
        TE.sample(gauss("torch")[0], x0, replay(0), **kw)
    assert str(et.value) == str(ej.value)


def test_non_finite_start_raises_as_jax():
    kw = dict(n_samples=4, burn=1)
    with pytest.raises(ValueError) as ej:
        JE.sample(lambda x: jax.numpy.sum(x) * np.nan, X0, jax.random.key(0), **kw)
    with pytest.raises(ValueError, match="real number") as et:
        TE.sample(lambda x: torch.sum(x) * np.nan, X0, replay(0), **kw)
    assert str(et.value) == str(ej.value)


def test_integer_seed_runs_without_a_replay():
    f, _ = gauss("torch")
    a, wa = TE.sample(f, X0, 5, n_samples=16, burn=2, LB=LB3, UB=UB3)
    b, wb = TE.sample(f, X0, 5, n_samples=16, burn=2, LB=LB3, UB=UB3)
    assert np.array_equal(a["samples"], b["samples"]) and np.array_equal(wa, wb)
    assert np.all(a["samples"] >= LB3) and np.all(a["samples"] <= UB3)
