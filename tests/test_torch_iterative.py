"""The port's matrix-free tier (``gpyreg_tpu_torch.ops.iterative``)
against ``gpyreg_tpu.ops.iterative`` on the CPU in float64, at 1e-8
relative, with the JAX package's Rademacher probes injected
(``tests/torch_replay.patch_probes``) and the same CG iteration counts: the panel matvec, CG (plain,
preconditioned, warm-started; the same iteration counts), the pivoted
Cholesky and its Woodbury preconditioner, the row padding, Lanczos and
SLQ, ``cg_nlml`` cold and warm with and without its gradient, with user
noise and with a ``row_chunk`` that forces padding, ``cg_log_post_raw``,
``cg_posterior_weights``, ``cg_predict`` (with and without the
preconditioner, with ``s2``, padded) and ``fit_cg``.  The CPU runs the
plain composition of every panel; ``tests/test_torch_cuda.py`` holds the
kernel-built panels to it on the card.

The GP problems take a noise sn = 3 (data noise 3): on a kernel matrix
whose spectrum clusters at sn2, CG in finite precision turns chaotic once
it runs past about 15 iterations (at sn = 0.5, two implementations whose
operators differ by 1e-13 reach residuals 2% apart at iteration 40 and a
different iteration count), so counts and 1e-8 agreement hold only where
the solves converge before that; at sn = 3 they reach 1e-9 in about 15
iterations with residuals that agree to 1e-16.  The accuracy checks
against the exact NLML use the JAX package's own problem and settings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpyreg_tpu.core import model as MJ
from gpyreg_tpu.ops import iterative as IJ
from gpyreg_tpu_torch.core import model as MT
from gpyreg_tpu_torch.ops import iterative as IT
from torch_replay import patch_probes

torch.set_num_threads(1)

RTOL = 1e-8
D = 3


@pytest.fixture(autouse=True)
def _jax_probes(monkeypatch):
    patch_probes(monkeypatch)


def _rel(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.max(np.abs(a - b), initial=0.0) / max(np.max(np.abs(b), initial=0.0), 1.0)


def _specs(cov="se", user_noise=False):
    kw = dict(D=D, cov=cov, mean="const", noise_constant=True,
              noise_user=int(user_noise), noise_rectified=False)
    return MT.ModelSpec(**kw), MJ.ModelSpec(**kw)


def _data(N=150, seed=0, user_noise=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 3.0 * rng.normal(size=(N, 1))
    s2 = rng.uniform(0.01, 0.05, size=(N, 1)) if user_noise else None
    hyp = np.concatenate([0.2 * rng.normal(size=D), [0.1], [np.log(3.0)], [0.1]])
    return X, y, s2, hyp


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("cov", ["se", "m5", "rq", "m3_iso"])
def test_panel_matvec_matches_jax(cov):
    spec_t, spec_j = _specs(cov)
    rng = np.random.default_rng(1)
    N, B = 96, 4
    X = rng.normal(size=(N, D))
    hyp_cov = 0.2 * rng.normal(size=spec_t.cov_N)
    V = rng.normal(size=(N, B))
    sn2 = np.full((N,), 0.1)
    out_t = IT._panel_matvec(spec_t, _t(hyp_cov), _t(X), _t(V), _t(sn2), 32)
    out_j = IJ._panel_matvec(spec_j, _j(hyp_cov), _j(X), _j(V), _j(sn2), 32)
    assert _rel(out_t, out_j) < 1e-12
    assert _rel(IT._panel_matvec(spec_t, _t(hyp_cov), _t(X), _t(V), None, 32),
                np.asarray(out_j) - 0.1 * V) < 1e-12


def _spd(N=64, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(N, N))
    return A @ A.T + 0.5 * N * np.eye(N), rng.normal(size=(N, 3))


@pytest.mark.parametrize("case", ["plain", "warm", "precond"])
def test_cg_matches_jax_with_the_same_iterations(case):
    A, B = _spd()
    kw_t, kw_j = {}, {}
    if case == "warm":
        x0 = np.linalg.solve(A + 0.3 * np.eye(A.shape[0]), B)
        kw_t["x0"], kw_j["x0"] = _t(x0), _j(x0)
    if case == "precond":
        d = 1.0 / np.diag(A)
        kw_t["precond"] = lambda v: v * _t(d)[:, None]
        kw_j["precond"] = lambda v: v * _j(d)[:, None]
    X_t, res_t, it_t = IT._cg(lambda v: _t(A) @ v, _t(B), 1e-10, 500, **kw_t)
    X_j, res_j, it_j = IJ._cg(lambda v: _j(A) @ v, _j(B), 1e-10, 500, **kw_j)
    assert it_t == int(it_j) and it_t > 3
    assert _rel(X_t, X_j) < RTOL
    assert np.all(res_t.numpy() < 1e-10)
    assert _rel(res_t * 1e10, np.asarray(res_j) * 1e10) < 1e-5


def test_cg_stops_at_max_iter_and_reports_it():
    A, B = _spd()
    X_t, res_t, it_t = IT._cg(lambda v: _t(A) @ v, _t(B), 1e-14, 4)
    X_j, res_j, it_j = IJ._cg(lambda v: _j(A) @ v, _j(B), 1e-14, 4)
    assert it_t == int(it_j) == 4
    assert np.all(res_t.numpy() > 1e-14)
    assert _rel(X_t, X_j) < RTOL and _rel(res_t, res_j) < RTOL


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_pivoted_cholesky_and_woodbury_match_jax(masked):
    spec_t, spec_j = _specs()
    X, _, _, hyp = _data(N=128)
    mask = (np.arange(128) < 120).astype(np.float64) if masked else None
    Lk_t = IT.pivoted_cholesky(spec_t, _t(hyp[: D + 1]), _t(X), 12, _t(mask))
    Lk_j = IJ.pivoted_cholesky(spec_j, _j(hyp[: D + 1]), _j(X), 12, _j(mask))
    assert _rel(Lk_t, Lk_j) < RTOL
    sn2 = np.random.default_rng(3).uniform(0.05, 0.2, size=128)
    v = np.random.default_rng(4).normal(size=(128, 2))
    a_t = IT.woodbury_preconditioner(Lk_t, _t(sn2))(_t(v))
    a_j = IJ.woodbury_preconditioner(Lk_j, _j(sn2))(_j(v))
    assert _rel(a_t, a_j) < RTOL


def test_padding_matches_jax():
    X, y, s2, _ = _data(N=150, user_noise=True)
    for s in (None, s2):
        out_t = IT._pad_panel_batch(_t(X), _t(y), _t(s), 64)
        out_j = IJ._pad_panel_batch(_j(X), _j(y), _j(s), 64)
        assert out_t[3] == int(out_j[3]) == 150
        for a, b in zip(out_t[:3], out_j[:3]):
            if b is None:
                assert a is None
            else:
                assert torch.equal(a, _t(np.asarray(b)))
    Xp, n = IT._pad_rows(_t(X), 50)
    assert n == 150 and Xp.shape[0] == 150
    assert IT._pad_panel_batch(_t(X), _t(y), None, 50)[3] is None


def test_lanczos_and_slq_match_jax():
    A, _ = _spd(N=80, seed=5)
    Z = np.asarray(jax.random.rademacher(jax.random.key(2), (80, 6), dtype=jnp.float64))
    al_t, be_t = IT.lanczos_tridiag(lambda v: _t(A) @ v, _t(Z), 12)
    al_j, be_j = IJ.lanczos_tridiag(lambda v: _j(A) @ v, _j(Z), 12)
    assert al_t.shape == (12, 6) and be_t.shape == (11, 6)
    assert _rel(al_t, al_j) < RTOL and _rel(be_t, be_j) < RTOL
    ld_t = IT.slq_logdet(lambda v: _t(A) @ v, 80, 2, torch.float64, 6, 12,
                         device="cpu")
    ld_j = IJ.slq_logdet(lambda v: _j(A) @ v, 80, jax.random.key(2), jnp.float64,
                         6, 12)
    assert _rel(ld_t, ld_j) < RTOL
    exact = np.linalg.slogdet(A)[1]
    assert abs(float(ld_t) - exact) / abs(exact) < 0.05


# (user noise, row_chunk): 150 rows in panels of 64 pad to 192.
NLML_CASES = {"plain": (False, 50), "padded": (False, 64),
              "s2_padded": (True, 64)}


@pytest.mark.parametrize("grad", [False, True], ids=["value", "grad"])
@pytest.mark.parametrize("name", sorted(NLML_CASES))
def test_cg_nlml_matches_jax_cold_and_warm(name, grad):
    user_noise, rc = NLML_CASES[name]
    spec_t, spec_j = _specs(user_noise=user_noise)
    X, y, s2, hyp = _data(user_noise=user_noise)
    kw = dict(compute_grad=grad, tol=1e-8, row_chunk=rc, max_iter=500,
              n_probes=6, n_lanczos=20, return_sol=True)
    out_t = IT.cg_nlml(spec_t, hyp, _t(X), _t(y), _t(s2), key=3, **kw)
    out_j = IJ.cg_nlml(spec_j, hyp, X, y, s2, key=jax.random.key(3), **kw)
    assert _rel(out_t[0], out_j[0]) < RTOL
    if grad:
        assert _rel(out_t[1], out_j[1]) < RTOL
    assert _rel(out_t[-2], out_j[-2]) < RTOL
    assert out_t[-1] == int(out_j[-1])
    # Warm start from the solution at a nearby point: fewer iterations,
    # the same values.
    h2 = hyp + 0.02
    w_t = IT.cg_nlml(spec_t, h2, _t(X), _t(y), _t(s2), key=3, sol0=out_t[-2], **kw)
    w_j = IJ.cg_nlml(spec_j, h2, X, y, s2, key=jax.random.key(3), sol0=out_j[-2], **kw)
    assert w_t[-1] == int(w_j[-1]) < out_t[-1]
    assert _rel(w_t[0], w_j[0]) < RTOL
    if grad:
        assert _rel(w_t[1], w_j[1]) < RTOL
    # Plain returns agree with the carried ones.
    plain = IT.cg_nlml(spec_t, hyp, _t(X), _t(y), _t(s2), key=3,
                       **{k: v for k, v in kw.items() if k != "return_sol"})
    assert (plain[0] if grad else plain) == out_t[0]


def test_cg_nlml_tracks_the_exact_nlml():
    """The estimator's accuracy on the JAX package's own test problem and
    bounds (tests/test_iterative.py:233-264), with its probes."""
    from gpyreg_tpu_torch.core.nlml import get_fns

    rng = np.random.default_rng(0)
    N, d = 512, 4
    X = rng.normal(size=(N, d))
    y = np.sum(np.sin(X), 1, keepdims=True) + 0.1 * rng.normal(size=(N, 1))
    spec = MT.ModelSpec(D=d, cov="se", mean="const", noise_constant=True,
                        noise_user=0, noise_rectified=False)
    hyp = np.concatenate([0.2 * rng.normal(size=d), [0.1], [-1.2], [0.1]])
    est, grad = IT.cg_nlml(spec, hyp, _t(X), _t(y), key=1, compute_grad=True,
                           row_chunk=128, n_probes=16, n_lanczos=40)
    v, g = get_fns(spec, False, False)["nlz_grad"](hyp, _t(X), _t(y))
    assert abs(est - float(v)) / abs(float(v)) < 0.01
    assert np.max(np.abs(grad - g.numpy())) / max(1.0, np.max(np.abs(g.numpy()))) < 0.15


def test_cg_log_post_raw_matches_jax():
    from gpyreg_tpu.core.priors import build_prior_pack as pack_j
    from gpyreg_tpu_torch.core.priors import build_prior_pack as pack_t

    spec_t, spec_j = _specs(user_noise=True)
    X, y, s2, hyp = _data(user_noise=True)
    n = spec_t.hyp_N
    table = {"mu": np.zeros(n), "sigma": np.full(n, 2.0), "df": np.zeros(n),
             "a": np.full(n, np.nan), "b": np.full(n, np.nan)}
    lb, ub = np.full(n, -10.0), np.full(n, 10.0)
    pt = pack_t(table, lb, ub, log_norm=0.0, device="cpu")
    pj = pack_j(table, lb, ub, log_norm=0.0)
    f_t, p_t = IT.cg_log_post_raw(spec_t, 1e-8, 64, 500, 6, 20, True, True)
    f_j, p_j = IJ.cg_log_post_raw(spec_j, 1e-8, 64, 500, 6, 20, True, True)
    h = torch.as_tensor(hyp)
    assert _rel(f_t(h, _t(X), _t(y), _t(s2), pt, 4),
                f_j(hyp, X, y, s2, pj, jax.random.key(4))) < RTOL
    assert _rel(p_t(h, _t(X), _t(y), _t(s2), pt, 4),
                p_j(hyp, X, y, s2, pj, jax.random.key(4))) < RTOL


def test_cg_posterior_weights_match_jax():
    spec_t, spec_j = _specs()
    X, y, _, hyp = _data(N=128)
    a_t, r_t, it_t = IT.cg_posterior_weights(spec_t, hyp, _t(X), _t(y), None,
                                             tol=1e-8, row_chunk=32)
    a_j, r_j, it_j = IJ.cg_posterior_weights(spec_j, hyp, _j(X), _j(y), None,
                                             tol=1e-8, row_chunk=32)
    assert it_t == int(it_j) and _rel(a_t, a_j) < RTOL
    assert float(r_t[0]) < 1e-8


# (user noise, precond rank, row_chunk)
PREDICT_CASES = {"plain": (False, 0, 50), "precond": (False, 20, 50),
                 "s2": (True, 0, 50), "padded_precond": (False, 20, 64)}


@pytest.mark.parametrize("name", sorted(PREDICT_CASES))
def test_cg_predict_matches_jax(name):
    user_noise, rank, rc = PREDICT_CASES[name]
    spec_t, spec_j = _specs(user_noise=user_noise)
    X, y, s2, hyp = _data(user_noise=user_noise)
    xs = np.random.default_rng(7).normal(size=(40, D))
    kw = dict(compute_var=True, tol=1e-8, row_chunk=rc, test_chunk=16,
              precond_rank=rank)
    mu_t, var_t, info_t = IT.cg_predict(spec_t, hyp, _t(X), _t(y), _t(s2),
                                        _t(xs), **kw)
    mu_j, var_j, info_j = IJ.cg_predict(spec_j, hyp, X, y, s2, xs, **kw)
    assert _rel(mu_t, mu_j) < RTOL and _rel(var_t, var_j) < RTOL
    assert info_t["alpha_iters"] == info_j["alpha_iters"]
    assert _rel(info_t["alpha"], info_j["alpha"]) < RTOL
    assert info_t["var_rel_residual"] < 1e-8 and info_t["var_iters"] > 0
    again = IT.cg_predict(spec_t, hyp, _t(X), _t(y), _t(s2), _t(xs),
                          alpha0=info_t["alpha"], **kw)
    assert np.array_equal(again[0], mu_t) and again[2]["alpha_reused"]


def test_fit_cg_matches_jax():
    spec_t, spec_j = _specs()
    X, y, _, hyp = _data(N=128)
    LB = np.full(hyp.shape, -5.0)
    UB = np.full(hyp.shape, 5.0)
    # sn >= 1 and sf <= e: every solve stays out of the chaotic regime.
    LB[D + 1], UB[D] = 0.0, 1.0
    kw = dict(LB=LB, UB=UB, tol=1e-6, cg_tol=1e-8, row_chunk=48, n_probes=4,
              n_lanczos=16, max_opt_iter=8)
    h_t, res_t = IT.fit_cg(spec_t, _t(X), _t(y), hyp0=hyp, key=5, **kw)
    h_j, res_j = IJ.fit_cg(spec_j, X, y, hyp0=hyp, key=jax.random.key(5), **kw)
    assert _rel(h_t, h_j) < 1e-6 and abs(res_t.fun - res_j.fun) < 1e-8 * abs(res_j.fun)
    assert res_t.nit == res_j.nit and res_t.nfev == res_j.nfev
    assert np.array_equal(res_t.cg_iters, np.asarray(res_j.cg_iters))
