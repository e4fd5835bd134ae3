"""The port's distributed exact GP (``gpyreg_tpu_torch.parallel.dist_exact``)
against ``gpyreg_tpu.parallel.dist_exact`` on the CPU in float64.

The port's mesh is ``make_mesh(8, device="cpu")``, eight shards on the
CPU; the JAX package's is its 8-device virtual CPU mesh
(``tests/conftest.py``).  Both sides take the same numpy inputs (the
cases of ``tests/test_dist_exact.py``).  The NLML agrees to 1e-10
relative, alpha, the factor, the predictive mean and variance to 1e-10;
the padded rows of alpha are exactly 0 and each slab row's entries
right of its own global column exactly 0.  The port deals B's panels
round-robin over its shards; the factor is compared after its shards'
rows are put back in global order through ``DistExactPosterior.
shard_rows``.  ``convert.dist_exact_from_arrays`` deals the JAX package's
own factor into that layout, and the port's ``dist_exact_predict`` on it
agrees with JAX's to the same tolerance.  Also covered: the model zoo,
heteroskedastic and rectified noise, both ``algorithm`` names, jitter,
the refusals of output warping and of an unknown algorithm, ``plan``, a
failed factorization giving NaN on both sides, and float32 against the
float64 oracle."""

import numpy as np
import pytest
import torch

import gpyreg_tpu  # noqa: F401  (float64 on)
from gpyreg_tpu.core import model as JM
from gpyreg_tpu.parallel import dist_exact as JDE
from gpyreg_tpu.parallel import mesh as JMESH
from gpyreg_tpu_torch.convert import dist_exact_from_arrays
from gpyreg_tpu_torch.core import model as TM
from gpyreg_tpu_torch.parallel import dist_exact as TDE
from gpyreg_tpu_torch.parallel import mesh as TMESH

torch.set_num_threads(1)

TOL = 1e-10
T_MESH = TMESH.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return JMESH.make_mesh(8)


def _specs(**kw):
    args = dict(noise_constant=True, noise_user=0, noise_rectified=False)
    args.update(kw)
    return JM.ModelSpec(**args), TM.ModelSpec(**args)


def _data(N, D, M=64, seed=0, noisy_s2=False):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (N, D))
    y = np.sin(X.sum(1))[:, None] + 0.1 * rng.normal(size=(N, 1))
    xs = rng.uniform(-3, 3, (M, D))
    s2 = 0.01 + 0.05 * rng.uniform(size=(N, 1)) if noisy_s2 else None
    return X, y, xs, s2


def _hyp(spec, seed=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        0.3 * rng.normal(size=spec.cov_N),
        -1.0 + 0.2 * rng.normal(size=spec.noise_N),
        0.1 * rng.normal(size=spec.mean_N),
    ])


def _both(jmesh, specs, hyp, X, y, s2=None, **kw):
    return (JDE.dist_exact_fit(specs[0], jmesh, hyp, X, y, s2=s2, **kw),
            TDE.dist_exact_fit(specs[1], T_MESH, hyp, X, y, s2=s2, **kw))


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _global_factor(post):
    """The shards' rows of the factor put back in global order."""
    out = torch.empty(post.Np, post.Np, dtype=post.slabs[0].dtype)
    for i, slab in enumerate(post.slabs):
        out[post.shard_rows(i)] = slab
    return out


def _same_posterior(jpost, tpost, xs, chunk=1024):
    assert float(tpost.nlml) == pytest.approx(float(jpost.nlml), rel=TOL)
    assert _max_abs(tpost.alpha.numpy(), jpost.alpha) < TOL
    assert _max_abs(_global_factor(tpost).numpy(), jpost.slab) < TOL
    mu_j, s2_j = JDE.dist_exact_predict(jpost, xs, chunk=chunk)
    mu_t, s2_t = TDE.dist_exact_predict(tpost, xs, chunk=chunk)
    assert _max_abs(mu_t, mu_j) < TOL
    assert _max_abs(s2_t, s2_j) < TOL


@pytest.mark.parametrize("N,b", [(512, 32), (500, 32), (130, 16), (512, 64)])
def test_fit_and_predict_equal_the_jax_tier(jmesh, N, b):
    specs = _specs(D=3, cov="se", mean="const")
    X, y, xs, _ = _data(N, 3)
    hyp = _hyp(specs[1])
    jpost, tpost = _both(jmesh, specs, hyp, X, y, b=b)
    _same_posterior(jpost, tpost, xs, chunk=32)
    assert (tpost.Np, tpost.b) == (jpost.Np, jpost.b)
    assert torch.all(tpost.alpha[N:] == 0.0)
    rows = tpost.Np // T_MESH.size
    cols = torch.arange(tpost.Np)
    for i, slab in enumerate(tpost.slabs):
        assert tuple(slab.shape) == (rows, tpost.Np)
        # Each row's entries right of its own global column.
        upper = cols[None, :] > tpost.shard_rows(i)[:, None]
        assert torch.all(slab[upper] == 0.0)

    # The JAX package's own factor, served by the port.
    conv = dist_exact_from_arrays(
        specs[1], T_MESH, jpost.b, jpost.n_real, jpost.hyp, jpost._X_pad,
        np.asarray(jpost.slab), np.asarray(jpost.alpha),
        np.asarray(jpost.sW), np.asarray(jpost.nlml))
    mu_j, s2_j = JDE.dist_exact_predict(jpost, xs)
    mu_c, s2_c = TDE.dist_exact_predict(conv, xs)
    assert _max_abs(mu_c, mu_j) < TOL and _max_abs(s2_c, s2_j) < TOL
    assert float(conv.nlml) == float(jpost.nlml)


@pytest.mark.parametrize("N,b,P", [(512, 32, 8), (500, 32, 4), (130, 16, 8)])
def test_dist_exact_from_arrays_deals_the_jax_factor(jmesh, N, b, P):
    """The JAX package's factor and alpha, dealt onto the port's shards,
    are the port's own rows of them, bit for bit, and come back whole."""
    specs = _specs(D=3, cov="se", mean="const")
    X, y, _, _ = _data(N, 3, seed=7)
    hyp = _hyp(specs[1], seed=8)
    jpost = JDE.dist_exact_fit(specs[0], jmesh, hyp, X, y, b=b)
    slab, alpha = np.asarray(jpost.slab), np.asarray(jpost.alpha)
    mesh = TMESH.make_mesh(P, device="cpu")
    conv = dist_exact_from_arrays(
        specs[1], mesh, jpost.b, jpost.n_real, jpost.hyp, jpost._X_pad,
        slab, alpha, np.asarray(jpost.sW), np.asarray(jpost.nlml))
    rows = jpost.Np // P
    for i in range(P):
        mine = TDE.dealt_rows(i, P, rows, jpost.b).numpy()
        # Local block l of shard i is panel l P + i.
        assert np.array_equal(mine.reshape(-1, jpost.b)[:, 0] // jpost.b,
                              np.arange(rows // jpost.b) * P + i)
        assert np.array_equal(conv.shard_rows(i).numpy(), mine)
        assert np.array_equal(conv.slabs[i].numpy(), slab[mine])
        assert np.array_equal(conv.alphas[i].numpy(), alpha[mine])
    assert np.array_equal(_global_factor(conv).numpy(), slab)
    assert np.array_equal(conv.alpha.numpy(), alpha)


@pytest.mark.parametrize("cov,mean",
                         [("m5", "negquad"), ("rq", "linear"),
                          ("se_iso", "zero")])
def test_model_zoo_equals_the_jax_tier(jmesh, cov, mean):
    specs = _specs(D=2, cov=cov, mean=mean)
    X, y, xs, _ = _data(260, 2, seed=3)
    jpost, tpost = _both(jmesh, specs, _hyp(specs[1], seed=4), X, y, b=16)
    _same_posterior(jpost, tpost, xs)


def test_heteroskedastic_and_rectified_noise_equal_the_jax_tier(jmesh):
    specs = _specs(D=2, cov="se", mean="const", noise_user=1,
                   noise_rectified=True)
    X, y, xs, s2 = _data(300, 2, seed=5, noisy_s2=True)
    jpost, tpost = _both(jmesh, specs, _hyp(specs[1], seed=6), X, y, s2=s2,
                         b=32)
    _same_posterior(jpost, tpost, xs)


@pytest.mark.parametrize("N,b", [(500, 16), (130, 16)])
def test_two_level_equals_masked_full_and_the_jax_two_level(jmesh, N, b):
    specs = _specs(D=3, cov="se", mean="const")
    X, y, xs, _ = _data(N, 3, seed=21)
    hyp = _hyp(specs[1], seed=22)
    jpost, tpost = _both(jmesh, specs, hyp, X, y, b=b,
                         algorithm="two_level")
    _same_posterior(jpost, tpost, xs)
    full = TDE.dist_exact_fit(specs[1], T_MESH, hyp, X, y, b=b)
    assert torch.equal(full.nlml, tpost.nlml)
    assert all(torch.equal(a, c) for a, c in zip(full.slabs, tpost.slabs))


def test_jitter_equals_the_jax_tier(jmesh):
    specs = _specs(D=2, cov="se", mean="zero")
    X, y, xs, _ = _data(96, 2, seed=11)
    jpost, tpost = _both(jmesh, specs, _hyp(specs[1], seed=12), X, y, b=16,
                         jitter=1e-3)
    _same_posterior(jpost, tpost, xs)


def test_a_failed_factorization_gives_nan_as_in_jax(jmesh):
    """B with a negative diagonal does not factor: the NLML is NaN on
    both sides, and the port raises nothing."""
    specs = _specs(D=2, cov="se", mean="zero")
    X, y, _, _ = _data(96, 2, seed=11)
    jpost, tpost = _both(jmesh, specs, _hyp(specs[1], seed=12), X, y, b=16,
                         jitter=-3.0)
    assert np.isnan(float(jpost.nlml)) and np.isnan(float(tpost.nlml))
    assert torch.all(torch.isnan(tpost.alpha[:96]))


def test_dist_exact_nlml_is_the_fit_nlml_and_timings_are_filled():
    specs = _specs(D=2, cov="se", mean="const")
    X, y, _, _ = _data(100, 2, seed=2)
    hyp = _hyp(specs[1], seed=3)
    tm = {}
    post = TDE.dist_exact_fit(specs[1], T_MESH, hyp, X, y, b=16, timings=tm)
    assert TDE.dist_exact_nlml(specs[1], T_MESH, hyp, X, y, b=16) == float(
        post.nlml)
    assert set(tm) == {"factor_s", "solve_s"} and min(tm.values()) >= 0.0


@pytest.mark.parametrize("N,P,b", [(1000, 8, 32), (130, 8, 16), (512, 4, 64),
                                   (1, 3, 32)])
def test_plan_equals_the_jax_plan(N, P, b):
    Np, rows, nb = TDE.plan(N, P, b)
    assert (Np, rows, nb) == JDE.plan(N, P, b)
    assert Np >= N and rows * P == Np and nb * b == Np and rows % b == 0


def test_output_warping_and_an_unknown_algorithm_are_refused():
    X, y, _, _ = _data(64, 2)
    spec = _specs(D=2, cov="se", mean="const", outwarp="negpow")[1]
    with pytest.raises(ValueError, match="output"):
        TDE.dist_exact_fit(spec, T_MESH, np.zeros(spec.hyp_N), X, y)
    spec = _specs(D=2, cov="se", mean="zero")[1]
    with pytest.raises(ValueError, match="algorithm"):
        TDE.dist_exact_fit(spec, T_MESH, np.zeros(spec.hyp_N), X, y,
                           algorithm="nope")


def test_float32_stays_close_to_the_float64_tier():
    """The bound of ``tests/test_dist_exact.py::test_dist_f32_fast_path``:
    B's eigenvalues are >= 1, so float32 loses only its rounding."""
    spec = _specs(D=3, cov="se", mean="const")[1]
    X, y, xs, _ = _data(384, 3, seed=13)
    hyp = _hyp(spec, seed=14)
    p64 = TDE.dist_exact_fit(spec, T_MESH, hyp, X, y, b=16)
    p32 = TDE.dist_exact_fit(spec, T_MESH, hyp, X.astype(np.float32),
                             y.astype(np.float32), b=16)
    assert p32.slabs[0].dtype == torch.float32
    assert float(p32.nlml) == pytest.approx(float(p64.nlml), rel=2e-4)
    mu64, s264 = TDE.dist_exact_predict(p64, xs)
    mu32, s232 = TDE.dist_exact_predict(p32, xs.astype(np.float32))
    assert _max_abs(mu32, mu64) < 5e-3 * max(1.0, float(np.max(np.abs(mu64))))
    assert _max_abs(s232, s264) < 5e-3
