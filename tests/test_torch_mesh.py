"""The port's mesh (``gpyreg_tpu_torch.parallel.mesh`` and ``GP(mesh=...)``)
against ``gpyreg_tpu``'s on the CPU in float64.

The port's mesh is ``make_mesh(8, device="cpu")``, eight shards on the
CPU; the JAX package's is its 8-device virtual CPU mesh
(``tests/conftest.py``), with the cases of ``tests/test_mesh.py``.  Both
sides take the same numpy inputs.  ``sharded_nlml_grad`` (a batch of 16
and a padded batch of 10) and ``sharded_predict`` (with padded factors
and ``n_real``) agree with JAX's to 1e-10; ``sharded_cg_weights`` (N = 32,
N = 30 padded to the mesh, and with user noise ``s2``) takes JAX's
iteration count, converged in
under 15 iterations where CG iterates stay in step, and agrees to 1e-8;
``sharded_sample_chains`` with 5 chains on the mesh of 8 and with 8
chains equals JAX's padded chains under the replay of the JAX key tree
(``tests/torch_replay.py``).  ``GP(mesh=8)``: ``fit`` gives the
single-device fit bit for bit and JAX's MAP objective to 1e-5 (two
optimizers run to ``tol_opt`` 1e-8, as ``test_torch_fit.py`` holds them);
``predict`` and ``quad`` with both parametrizations, ``update`` with its
rank-1 branch and ``random_function`` agree with the single-device GP to
1e-11 and with JAX's mesh GP to 1e-8, relative to max(1, the largest
value) (the explicit-inverse sample's
variance, which conditioning limits, to the 5e-3 relative that
``tests/test_mesh.py`` allows between JAX's own mesh and single device);
``fit(n_chains=6)`` on the mesh of 8 equals JAX's under the replay, and
the slicelite warm refit on the mesh equals the single-device refit; the
int shorthand builds the mesh."""

import numpy as np
import pytest
import torch

import gpyreg_tpu as gj
import gpyreg_tpu_torch as gt
from gpyreg_tpu.core import model as JM
from gpyreg_tpu.parallel import mesh as JMESH
from gpyreg_tpu_torch.core import model as TM
from gpyreg_tpu_torch.parallel import mesh as TMESH
from torch_replay import patch_streams

torch.set_num_threads(1)

T_MESH = TMESH.make_mesh(8, device="cpu")
TOL = 1e-10


@pytest.fixture(scope="module")
def jmesh():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    return JMESH.make_mesh(8)


def _specs(D=3):
    args = dict(D=D, cov="se", mean="const", noise_constant=True,
                noise_user=0, noise_rectified=False)
    return JM.ModelSpec(**args), TM.ModelSpec(**args)


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(32, 3))
    y = np.sum(np.sin(X), axis=1, keepdims=True)
    return X, y, rng


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _rel(a, b):
    """max |a - b| over max(1, max |b|)."""
    b = np.asarray(b)
    return _max_abs(a, b) / max(1.0, float(np.max(np.abs(b))))


def test_make_mesh_and_the_collectives(monkeypatch):
    m = TMESH.make_mesh(8, device="cpu")
    assert m.size == 8 and all(d == torch.device("cpu") for d in m.devices)
    assert TMESH.make_mesh(device="cpu").size == 1
    assert TMESH.make_mesh(devices=["cpu", "cpu", "cpu"]).size == 3
    with pytest.raises(ValueError):
        TMESH.Mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        TMESH.make_mesh(2)
    monkeypatch.undo()
    # The slices of 10 rows over 4 shards: 3 a shard, the last one short.
    assert TMESH.make_mesh(4, device="cpu").slices(10) == [
        (0, 3), (3, 6), (6, 9), (9, 10)]
    assert TMESH.make_mesh(4, device="cpu").slices(2) == [
        (0, 1), (1, 2), (2, 2), (2, 2)]
    parts = [torch.full((2, 1), float(i)) for i in range(3)]
    assert TMESH.all_gather(parts, "cpu")[:, 0].tolist() == [0, 0, 1, 1, 2, 2]
    assert TMESH.psum(parts, "cpu")[:, 0].tolist() == [3.0, 3.0]
    # replicate: one object a shard, no copy on the device it lies on.
    t = torch.ones(3)
    reps = m.replicate((t, 2))
    assert len(reps) == 8 and all(r[0] is t and r[1] == 2 for r in reps)


@pytest.mark.parametrize("B", [16, 10])
def test_sharded_nlml_grad_equals_jax(jmesh, B):
    X, y, rng = _setup()
    spec_j, spec_t = _specs()
    hyps = 0.1 * rng.normal(size=(B, spec_t.hyp_N))
    v_j, g_j = JMESH.sharded_nlml_grad(spec_j, jmesh, hyps, X, y)
    v_t, g_t = TMESH.sharded_nlml_grad(spec_t, T_MESH, hyps, torch.tensor(X),
                                       torch.tensor(y))
    assert tuple(v_t.shape) == (B,) and tuple(g_t.shape) == (B, spec_t.hyp_N)
    assert _max_abs(v_t, v_j) < TOL * max(1.0, float(np.max(np.abs(v_j))))
    assert _max_abs(g_t, g_j) < TOL * max(1.0, float(np.max(np.abs(g_j))))


def test_sharded_predict_equals_jax_with_and_without_padding(jmesh):
    X, y, rng = _setup()
    spec_j, spec_t = _specs()
    gp = gj.GP(3, gj.covariance_functions.SquaredExponential(),
               gj.mean_functions.ConstantMean(),
               gj.noise_functions.GaussianNoise(constant_add=True))
    hyp = np.concatenate([np.zeros(3), [0.0], [-1.0], [0.0]])[None, :]
    gp.update(X_new=X, y_new=y, hyp=hyp)
    p = gp.posteriors[0]
    xs = rng.normal(size=(17, 3))
    arrays = [np.asarray(a) for a in (p.alpha, p.L, p.sW)]
    mu_j, s2_j = JMESH.sharded_predict(spec_j, jmesh, p.hyp, *arrays, X,
                                       xs[:16])
    mu_t, s2_t = TMESH.sharded_predict(spec_t, T_MESH, p.hyp, *arrays, X,
                                       xs[:16])
    assert _max_abs(mu_t, mu_j) < TOL and _max_abs(s2_t, s2_j) < TOL

    # The JAX GP's padded factors with their real row count; 17 points
    # leave the last shards short.
    N_pad, n_real = p._L.shape[0], X.shape[0]
    assert N_pad > n_real
    X_pad = np.zeros((N_pad, 3))
    X_pad[:n_real] = X
    padded = [np.asarray(a) for a in (p._alpha, p._L, p._sW)]
    mu_t, s2_t = TMESH.sharded_predict(spec_t, T_MESH, p.hyp, *padded, X_pad,
                                       xs, n_real=n_real)
    mu_r, s2_r = gp.predict(xs)
    assert _max_abs(mu_t, mu_r.ravel()) < 1e-8
    assert _max_abs(s2_t, s2_r.ravel()) < 1e-8
    mu_j, s2_j = JMESH.sharded_predict(spec_j, jmesh, p.hyp, *padded, X_pad,
                                       xs[:16], n_real=n_real)
    assert _max_abs(mu_t[:16], mu_j) < TOL and _max_abs(s2_t[:16], s2_j) < TOL


@pytest.mark.parametrize("N", [32, 30])
def test_sharded_cg_weights_equal_jax(jmesh, N):
    X, y, _ = _setup()
    spec_j, spec_t = _specs()
    # Short lengthscales and unit noise: CG converges in under 15
    # iterations, where two implementations stay in step.
    hyp = np.array([-1.0, -1.2, -0.8, -0.5, 0.0, 0.2])
    a_j, r_j, it_j = JMESH.sharded_cg_weights(spec_j, jmesh, hyp, X[:N],
                                              y[:N], tol=1e-10, max_iter=200)
    a_t, r_t, it_t = TMESH.sharded_cg_weights(spec_t, T_MESH, hyp, X[:N],
                                              y[:N], tol=1e-10, max_iter=200)
    assert it_t == int(it_j) < 15
    assert tuple(a_t.shape) == (N, 1)
    assert _max_abs(a_t, a_j) < 1e-8 * max(1.0, float(np.max(np.abs(a_j))))
    assert float(r_t.max()) < 1e-10
    K = TM.cov_matrix(spec_t, torch.tensor(hyp[:4]), torch.tensor(X[:N]))
    dense = torch.linalg.solve(K + np.exp(2 * hyp[4]) * torch.eye(N),
                               torch.tensor(y[:N] - hyp[5]))
    assert _max_abs(a_t, dense) < 1e-9


def test_sharded_cg_weights_with_user_noise_equal_jax(jmesh):
    X, y, rng = _setup()
    args = dict(D=3, cov="se", mean="const", noise_constant=True,
                noise_user=1, noise_rectified=False)
    spec_j, spec_t = JM.ModelSpec(**args), TM.ModelSpec(**args)
    s2 = 0.5 + rng.uniform(size=(30, 1))
    hyp = np.array([-1.0, -1.2, -0.8, -0.5, -0.5, 0.2])
    a_j, _, it_j = JMESH.sharded_cg_weights(spec_j, jmesh, hyp, X[:30], y[:30],
                                            s2=s2, tol=1e-10, max_iter=200)
    a_t, _, it_t = TMESH.sharded_cg_weights(spec_t, T_MESH, hyp, X[:30],
                                            y[:30], s2=s2, tol=1e-10,
                                            max_iter=200)
    assert it_t == int(it_j) < 15
    assert _rel(a_t, a_j) < 1e-8


@pytest.mark.parametrize("B", [5, 8])
def test_sharded_sample_chains_equal_the_jax_padded_chains(jmesh, monkeypatch,
                                                          B):
    import jax

    patch_streams(monkeypatch)
    X, y, rng = _setup()
    spec_j, spec_t = _specs()
    x0s = np.tile(np.concatenate([np.zeros(3), [0.0], [-1.0], [0.0]]),
                  (B, 1)) + 0.05 * rng.normal(size=(B, spec_t.hyp_N))
    kw = dict(widths=np.ones(spec_t.hyp_N), LB=x0s.min(0) - 5,
              UB=x0s.max(0) + 5, n_samples=6, burn=4)
    s_j, f_j = JMESH.sharded_sample_chains(spec_j, jmesh, x0s,
                                           jax.random.key(2), X, y, **kw)
    s_t, f_t, n_evals, n_sweeps = TMESH.sharded_sample_chains(
        spec_t, T_MESH, x0s, 2, X, y, **kw)
    assert s_t.shape == (B, 6, spec_t.hyp_N) and n_evals.shape == (B,)
    assert np.all(n_sweeps == 10)
    assert _max_abs(s_t, s_j) < 1e-10
    assert _max_abs(f_t, f_j) < 1e-10 * max(1.0, float(np.max(np.abs(f_j))))


# --------------------------------------------------------------------------
# GP(mesh=...)
# --------------------------------------------------------------------------


def _make(m, **kw):
    return m.GP(2, m.covariance_functions.SquaredExponential(),
                m.mean_functions.ConstantMean(),
                m.noise_functions.GaussianNoise(constant_add=True), **kw)


def _gp_data():
    rng = np.random.default_rng(3)
    X = rng.uniform(-3, 3, (70, 2))
    y = np.sin(np.sum(X, 1))[:, None] + 0.1 * rng.normal(size=(70, 1))
    return X, y, rng


# Two samples across the L_chol split: the high-noise one in the Cholesky
# parametrization, the low-noise one in the explicit negative inverse.
MIXED = np.array([[0.0, 0.0, 0.3, -2.0, 0.0], [0.0, 0.0, 0.3, -9.0, 0.0]])


@pytest.fixture(scope="module")
def gps(jmesh):
    X, y, _ = _gp_data()
    out = {
        "jax": _make(gj, mesh=jmesh),
        "mesh": _make(gt, mesh=T_MESH, device="cpu"),
        "single": _make(gt, device="cpu"),
    }
    for g in out.values():
        g.update(X_new=X, y_new=y, hyp=MIXED)
    assert [p.L_chol for p in out["mesh"].posteriors] == [True, False]
    return out


def test_gp_mesh_predict_equals_single_device_and_jax(gps):
    xs = np.random.default_rng(4).uniform(-3, 3, (41, 2))  # not a multiple of 8
    mu_m, s2_m = gps["mesh"].predict(xs, separate_samples=True)
    mu_s, s2_s = gps["single"].predict(xs, separate_samples=True)
    mu_j, s2_j = gps["jax"].predict(xs, separate_samples=True)
    assert _rel(mu_m, mu_s) < 1e-12 and _rel(s2_m, s2_s) < 1e-12
    assert _rel(mu_m, mu_j) < 1e-8
    assert _rel(s2_m[:, 0], s2_j[:, 0]) < 1e-8
    np.testing.assert_allclose(s2_m[:, 1], s2_j[:, 1], rtol=5e-3, atol=1e-8)


def test_gp_mesh_quad_equals_single_device_and_jax(gps):
    rng = np.random.default_rng(5)
    mu = rng.uniform(-2, 2, (13, 2))  # not a multiple of 8
    sigma = rng.uniform(0.1, 1.0, (13, 2))
    F_m, V_m = gps["mesh"].quad(mu, sigma, compute_var=True)
    F_s, V_s = gps["single"].quad(mu, sigma, compute_var=True)
    F_j, V_j = gps["jax"].quad(mu, sigma, compute_var=True)
    assert _rel(F_m, F_s) < 1e-11 and _rel(V_m, V_s) < 1e-11
    assert _rel(F_m, F_j) < 1e-8
    np.testing.assert_allclose(V_m, V_j, rtol=5e-3, atol=1e-10)
    # One sigma for every measure, samples kept apart.
    F_m = gps["mesh"].quad(mu, 0.5, separate_samples=True)
    assert _rel(F_m, gps["single"].quad(mu, 0.5, separate_samples=True)) < 1e-11
    assert _rel(F_m, gps["jax"].quad(mu, 0.5, separate_samples=True)) < 1e-8


def test_gp_mesh_update_and_random_function(jmesh):
    X, y, rng = _gp_data()
    hyp = MIXED[:1]
    sides = {"jax": _make(gj, mesh=jmesh),
             "mesh": _make(gt, mesh=T_MESH, device="cpu"),
             "single": _make(gt, device="cpu")}
    for g in sides.values():
        g.update(X_new=X[:-1], y_new=y[:-1], hyp=hyp)
        g.update(X_new=X[-1:], y_new=y[-1:])  # the rank-1 branch
    xs = rng.uniform(-3, 3, (17, 2))
    mu_m, s2_m = sides["mesh"].predict(xs)
    for name, tol in (("single", 1e-12), ("jax", 1e-8)):
        mu, s2 = sides[name].predict(xs)
        assert _rel(mu_m, mu) < tol and _rel(s2_m, s2) < tol
    mu_q = rng.uniform(-2, 2, (9, 2))
    assert _rel(sides["mesh"].quad(mu_q, 0.4),
                sides["jax"].quad(mu_q, 0.4)) < 1e-8
    draws = {}
    for name, g in sides.items():
        np.random.seed(21)
        draws[name] = g.random_function(xs)
    assert _rel(draws["mesh"], draws["single"]) < 1e-12
    assert _rel(draws["mesh"], draws["jax"]) < 1e-7


def test_gp_mesh_fit_is_the_single_device_fit_and_reaches_the_jax_map(jmesh):
    X, y, rng = _gp_data()
    opts = {"n_samples": 0, "opts_N": 2, "init_N": 32, "tol_opt": 1e-8}
    out = {}
    for name, g in (("mesh", _make(gt, mesh=T_MESH, device="cpu")),
                    ("single", _make(gt, device="cpu")),
                    ("jax", _make(gj, mesh=jmesh))):
        np.random.seed(7)
        out[name] = (g,) + g.fit(X=X, y=y, options=dict(opts))
    (g_m, hyp_m, res_m, _), (g_s, hyp_s, res_s, _) = out["mesh"], out["single"]
    assert np.array_equal(hyp_m, hyp_s) and res_m.fun == res_s.fun
    assert [r.nit for r in g_m.fit_report["restarts"]] == [
        r.nit for r in g_s.fit_report["restarts"]]
    assert g_m.fit_report["design_best"] == g_s.fit_report["design_best"]
    f_j = out["jax"][2].fun
    assert abs(res_m.fun - f_j) <= 1e-5 * max(1.0, abs(f_j))
    xs = rng.uniform(-3, 3, (33, 2))
    mu_m, s2_m = g_m.predict(xs)
    mu_s, s2_s = g_s.predict(xs)
    assert _rel(mu_m, mu_s) < 1e-12 and _rel(s2_m, s2_s) < 1e-12


def test_gp_mesh_fit_chains_equal_the_jax_chains(jmesh, monkeypatch):
    """fit(n_chains=6) on the mesh of 8: JAX pads the chains to 8 and
    splits its key 8 ways; the port splits its stream the same way.  With
    ``opts_N`` 0 both chains start from the best row of the same design
    (two optimizers' MAPs would differ at 1e-5 and the chains with them)."""
    patch_streams(monkeypatch)
    X, y, _ = _gp_data()
    opts = {"n_samples": 6, "opts_N": 0, "init_N": 16, "thin": 2,
            "n_chains": 6}
    out = {}
    for name, g in (("torch", _make(gt, mesh=T_MESH, device="cpu")),
                    ("jax", _make(gj, mesh=jmesh))):
        np.random.seed(5)
        out[name] = g.fit(X=X, y=y, options=dict(opts))[2]
    sr_t, sr_j = out["torch"], out["jax"]
    assert sr_t["n_chains"] == 6 and sr_t["samples"].shape == (12, 5)
    for k in ("samples", "f_vals", "log_priors", "R", "eff_N"):
        assert _rel(sr_t[k], np.asarray(sr_j[k], dtype=np.float64)) <= 1e-8
    assert sr_t["exit_flag"] == sr_j["exit_flag"]


def test_gp_mesh_int_shorthand():
    g = _make(gt, mesh=8, device="cpu")
    assert isinstance(g.mesh, TMESH.Mesh) and g.mesh.size == 8
    assert all(d.type == "cpu" for d in g.mesh.devices)
    assert _make(gt, device="cpu").mesh is None


def test_gp_mesh_slicelite_refit_is_the_single_device_refit():
    """The slicelite warm refit hands the mesh to its chains: with as many
    chains as shards (no padding) the refit equals the single-device one."""
    X, y, _ = _gp_data()
    opts = {"n_samples": 8, "thin": 2, "burn": 8, "init_N": 16, "opts_N": 0,
            "sampler": "slicelite"}
    out = {}
    for name, g in (("mesh", _make(gt, mesh=T_MESH, device="cpu")),
                    ("single", _make(gt, device="cpu"))):
        np.random.seed(1)
        g.fit(X=X, y=y, options=dict(opts))
        np.random.seed(2)
        out[name] = g.fit(X=X[:-1], y=y[:-1], options=dict(opts))[2]
    sr_m, sr_s = out["mesh"], out["single"]
    assert "ess_frac" in sr_m  # the warm-refit shortcut ran
    for k in ("samples", "f_vals", "log_priors", "n_evals"):
        assert np.array_equal(sr_m[k], sr_s[k]), k
