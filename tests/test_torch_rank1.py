"""The port's rank-1 ``GP.update`` (``gpyreg_tpu_torch/core/rank1.py``)
against the JAX package's on the CPU, in float64.

Both GPs are conditioned on the same N = 50 rows and hyperparameter
samples, then take the same new points one at a time.  At N = 50 the JAX
package updates inside its 64-row bucket; the port grows each factor.
``L``, ``alpha``, ``sW`` and ``predict`` agree to 1e-8 relative after 1
and after 3 updates, for the Cholesky parametrization (sn = 0.1), the
inverse one (log sn = -8, below ``LCHOL_THRESHOLD``) and samples that
straddle the threshold, with ARD se, m5 and se_iso.  That both took the
rank-1 path shows in their ``Posterior`` objects, which a rank-1 update
keeps and a rebuild replaces.
"""

import warnings

import numpy as np
import pytest
import torch

import gpyreg_tpu_torch as gt
from torch_serving_cases import RTOL, data, factors, make, pair, rel

torch.set_num_threads(1)

CHOL, INV, STRADDLE = (-2.3, -2.2, -2.0), (-8.0, -8.1, -7.9), (-2.3, -8.0, -2.0)
CASES = {
    "chol_se": ("se", CHOL),
    "inv_se": ("se", INV),
    "straddle_se": ("se", STRADDLE),
    "chol_m5": ("m5", CHOL),
    "straddle_m5": ("m5", STRADDLE),
    "chol_se_iso": ("se_iso", CHOL),
    "inv_se_iso": ("se_iso", INV),
}


def _new_point(rng, D):
    x = rng.uniform(-3, 3, (1, D))
    return x, np.sin(np.sum(x, axis=1, keepdims=True))


def _ids(gp):
    """The Posterior objects themselves, compared by identity: holding
    them keeps a freed object's id from being reused by a new one."""
    return list(gp.posteriors)


def _check(g, t, rng, what):
    for pj, pt in zip(g.posteriors, t.posteriors):
        assert pt.L_chol == pj.L_chol
        ft = factors(pt)
        n = g.X.shape[0]
        assert ft["L"].shape == (n, n) and ft["alpha"].shape == (n, 1)
        for f in ("L", "alpha", "sW"):
            assert rel(ft[f], np.asarray(getattr(pj, f))) < RTOL, (what, f)
    xs = rng.uniform(-3, 3, (20, g.D))
    (mj, sj), (mt, st) = g.predict(xs), t.predict(xs)
    assert rel(mt, mj) < RTOL and rel(st, sj) < RTOL, what


@pytest.mark.parametrize("n_updates", [1, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_one_updates_match_jax(name, n_updates):
    cov, log_sn = CASES[name]
    g, t, rng = pair(log_sn, cov=cov)
    ids_g, ids_t = _ids(g), _ids(t)
    for _ in range(n_updates):
        x, y = _new_point(rng, g.D)
        g.update(X_new=x, y_new=y)
        t.update(X_new=x, y_new=y)
    # Both packages kept their Posterior objects: no rebuild ran.
    assert _ids(g) == ids_g and _ids(t) == ids_t
    assert t.X.shape == (50 + n_updates, 2)
    _check(g, t, rng, name)


def test_at_a_full_bucket_jax_rebuilds_and_the_port_updates():
    """At N = 64 the JAX package's bucket is full and it rebuilds; the
    port extends its factors, which agree with the rebuild to 1e-8."""
    g, t, rng = pair(STRADDLE, N=64)
    ids_g, ids_t = _ids(g), _ids(t)
    x, y = _new_point(rng, 2)
    g.update(X_new=x, y_new=y)
    t.update(X_new=x, y_new=y)
    assert _ids(g) != ids_g and _ids(t) == ids_t
    _check(g, t, rng, "n64")


def test_an_unstable_update_warns_as_jax_and_equals_a_rebuild():
    """A point on top of a training row with log sn = -10: the inverse
    branch's predictive variance falls below its sqrt(eps) floor, and
    that sample alone is rebuilt on the grown data, in both packages.
    The Cholesky sample (sn = 0.1) updates in rank 1."""
    g, t, rng = pair((-2.3, -10.0))
    ids_t = _ids(t)
    x = g.X[7:8].copy()
    y = g.y[7:8].copy()
    with pytest.warns(UserWarning) as wj:
        g.update(X_new=x, y_new=y)
    with pytest.warns(UserWarning) as wt:
        t.update(X_new=x, y_new=y)
    texts = [str(w.message) for w in wt]
    assert texts == [str(w.message) for w in wj]
    assert texts == ["Rank-one posterior update unstable for posterior 1. "
                     "Reverting to full update."]
    assert _ids(t)[0] == ids_t[0] and _ids(t)[1] != ids_t[1]

    # The rebuilt sample is the port's own full rebuild, to the bit; the
    # updated one agrees with it to 1e-8.
    r = make(gt, 2)
    r.update(X_new=t.X, y_new=t.y, hyp=t.get_hyperparameters(as_array=True))
    for s, tol in ((1, 0.0), (0, RTOL)):
        fr, ft = factors(r.posteriors[s]), factors(t.posteriors[s])
        for f in ("L", "alpha", "sW"):
            assert rel(ft[f], fr[f]) <= tol, (s, f)
    xs = rng.uniform(-3, 3, (20, 2))
    mj, sj = g.predict(xs)
    mt, st = t.predict(xs)
    assert rel(mt, mj) < RTOL and np.max(np.abs(st - sj)) < 1e-7


def test_a_factor_the_caller_assigned_takes_the_full_rebuild():
    """Assigning ``L`` (even its own value) marks it as the caller's, as
    in the JAX package: the next single-point update rebuilds every
    sample."""
    g, t, rng = pair(CHOL)
    for m in (g, t):
        m.posteriors[1].L = m.posteriors[1].L
    ids_g, ids_t = _ids(g), _ids(t)
    x, y = _new_point(rng, 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g.update(X_new=x, y_new=y)
        t.update(X_new=x, y_new=y)
    assert not set(_ids(g)) & set(ids_g) and not set(_ids(t)) & set(ids_t)
    assert not any(p._direct for p in t.posteriors)
    _check(g, t, rng, "assigned")


def test_a_sample_that_raises_leaves_no_posterior_grown(monkeypatch):
    """The third sample's update raises: the error propagates, the data
    stay at N, the two samples already grown lose their factors, the last
    keeps its own, and the next single-point update rebuilds every sample
    (the result equals JAX's update of the same point)."""
    g, t, rng = pair(CHOL)
    before = factors(t.posteriors[2])
    calls = [0]
    chol_one = gt.gp._rank1.chol_one

    def third_raises(*args):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("out of memory")
        return chol_one(*args)

    monkeypatch.setattr(gt.gp._rank1, "chol_one", third_raises)
    x, y = _new_point(rng, 2)
    with pytest.raises(RuntimeError, match="out of memory"):
        t.update(X_new=x, y_new=y)
    assert t.X.shape == (50, 2) and t.y.shape == (50, 1)
    assert all(t.posteriors[s].alpha is None and t.posteriors[s].L is None
               for s in (0, 1))
    after = factors(t.posteriors[2])
    assert all(np.array_equal(after[f], before[f]) for f in before)
    with pytest.raises(ValueError, match="requires the posterior factors"):
        t.quad(np.zeros((1, 2)), 1.0)

    monkeypatch.undo()
    ids = _ids(t)
    g.update(X_new=x, y_new=y)
    t.update(X_new=x, y_new=y)
    assert not set(_ids(t)) & set(ids)
    _check(g, t, rng, "raised")


def _user_noise_gp(rng):
    X, y = data(rng, 50, 2)
    t = make(gt, 2, user_noise=True)
    hyp = 0.1 * rng.normal(size=(2, t._hyp_N()))
    hyp[:, 3] = -2.3
    t.update(X_new=X, y_new=y, s2_new=np.full((50, 1), 0.01), hyp=hyp)
    return t


@pytest.mark.parametrize("what", ["two_rows", "s2_new", "no_posterior",
                                  "numpy_factor"])
def test_what_is_not_a_single_point_update_rebuilds(what):
    """Two new rows, a new point with its own noise variance, an update
    without a posterior, and a factor that is no tensor on the GP's
    device all take the full rebuild: the result is the rebuild on the
    grown data."""
    _, t, rng = pair(CHOL)
    if what == "s2_new":
        t = _user_noise_gp(rng)
    ids = _ids(t)
    X, y = data(rng, 2, 2)
    kw = {"X_new": X[:1], "y_new": y[:1]}
    if what == "two_rows":
        kw = {"X_new": X, "y_new": y}
    elif what == "s2_new":
        kw["s2_new"] = np.full((1, 1), 0.02)
    elif what == "no_posterior":
        kw["compute_posterior"] = False
    else:
        t.posteriors[0]._L = t.posteriors[0].L.numpy()
    t.update(**kw)
    assert not set(_ids(t)) & set(ids)
    if what == "no_posterior":
        assert all(p.alpha is None for p in t.posteriors)
        return
    r = make(gt, 2, user_noise=what == "s2_new")
    r.update(X_new=t.X, y_new=t.y, s2_new=t.s2,
             hyp=t.get_hyperparameters(as_array=True))
    for pr, pt in zip(r.posteriors, t.posteriors):
        for f in ("L", "alpha", "sW"):
            assert torch.equal(getattr(pt, f), getattr(pr, f))
