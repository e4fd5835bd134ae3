"""The port's slice chain (``gpyreg_tpu_torch.inference.device_slice``)
against the JAX package's (``gpyreg_tpu.inference.device_slice``) on the
CPU, in float64.

Under the replay of the JAX key tree (``tests/torch_replay.py``) the
port's ``sample`` and ``sample_chains`` draw the JAX chain's uniforms
and scan orders, so they are held to it proposal by proposal: samples,
f_vals, log_priors, R and eff_N to 1e-10, the exit flag, the widths the
chain ends with, and the key it leaves.  The cases cover the
coordinate-wise and random-direction moves, adaptive and not,
``width_base`` True and False, step-out, a fixed dimension, infinite
bounds, the shrink-cap exit (``max_shrink`` 2), thinning, an additive
``log_prior`` and a chain continued through ``state=``.  The density of
each side is its own arithmetic (jnp in JAX, torch here); they agree to
a few ulps, far from the accept tests' margins at these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpyreg_tpu.inference.device_slice as JDS
from gpyreg_tpu_torch.inference import device_slice as TDS
from torch_replay import JaxReplay, replay

torch.set_num_threads(1)

TOL = 1e-10
SEED = 7

MU = np.array([0.3, -0.5, 1.0])
SD = np.array([0.5, 1.0, 2.0])
_TMU, _TSD = torch.tensor(MU), torch.tensor(SD)


def j_gauss(x):
    return -0.5 * jnp.sum(((x - MU) / SD) ** 2)


def t_gauss(x):
    return -0.5 * torch.sum(((x - _TMU) / _TSD) ** 2)


def j_prior(x):
    return -0.1 * jnp.sum(jnp.abs(x))


def t_prior(x):
    return -0.1 * torch.sum(torch.abs(x))


X0 = np.array([0.2, 0.2, 0.2])
BOX = dict(LB=-4.0, UB=5.0)
CASES = {
    "cw": dict(widths=[1.0, 1.0, 1.0], burn=10, n_samples=30, **BOX),
    "cw_width_base_false": dict(widths=[1.0, 1.0, 1.0], burn=10, n_samples=30,
                                width_base=False, **BOX),
    "cw_not_adaptive": dict(widths=0.7, burn=6, n_samples=20, adaptive=False, **BOX),
    "cw_step_out_fixed_dim": dict(LB=[-4.0, 0.2, -4.0], UB=[4.0, 0.2, 4.0], widths=0.1,
                                  burn=8, n_samples=20, step_out=True),
    "cw_infinite_bounds": dict(burn=10, n_samples=20),
    "cw_shrink_cap": dict(widths=3.0, burn=10, n_samples=20, max_shrink=2, **BOX),
    "cw_thin_log_prior": dict(widths=1.0, burn=6, n_samples=10, thin=3, prior=True,
                              **BOX),
    "rd": dict(widths=[1.0, 2.0, 1.5], burn=10, n_samples=30, move="rd", **BOX),
    "rd_width_base_false": dict(widths=[1.0, 2.0, 1.5], burn=10, n_samples=20, move="rd",
                                width_base=False, **BOX),
    "rd_fixed_dim_infinite_bounds": dict(LB=[-np.inf, 0.2, -3.0], UB=[np.inf, 0.2, np.inf],
                                         burn=8, n_samples=20, move="rd"),
    "rd_shrink_cap": dict(widths=4.0, burn=8, n_samples=20, move="rd", max_shrink=2,
                          **BOX),
}


def _kw(case, side):
    kw = dict(case)
    if kw.pop("prior", False):
        kw["log_prior"] = j_prior if side == "jax" else t_prior
    return kw


def _check(rt, rj):
    for k in ("samples", "f_vals", "log_priors", "R", "eff_N"):
        a, b = rt[k], rj[k]
        if b is None:
            assert a is None, k
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, k
        # A fixed dimension has no spread: NaN diagnostics on both sides.
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan), k
        a, b = a[~nan], b[~nan]
        assert np.max(np.abs(a - b), initial=0.0) <= TOL * max(
            1.0, np.max(np.abs(b), initial=0.0)), k
    assert rt["exit_flag"] == rj["exit_flag"]


def _check_state(st, sj, fixed):
    free = ~np.asarray(fixed)
    assert np.max(np.abs(st.x - np.asarray(sj.x))) <= TOL
    assert abs(st.log_Px - float(sj.log_Px)) <= TOL * max(1.0, abs(float(sj.log_Px)))
    # Fixed dimensions move in no chain; their widths are used by none.
    assert np.max(np.abs(st.widths - np.asarray(sj.widths))[free]) <= TOL
    assert np.array_equal(jax.random.key_data(st.stream.key), jax.random.key_data(sj.key))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, case in CASES.items():
        rj, sj = JDS.sample(j_gauss, X0, jax.random.key(SEED), **_kw(case, "jax"))
        rt, st = TDS.sample(t_gauss, X0, replay(SEED), **_kw(case, "torch"))
        out[name] = (rt, st, rj, sj)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_equals_the_jax_chain(name, runs):
    rt, st, rj, sj = runs[name]
    case = CASES[name]
    _check(rt, rj)
    assert rt["samples"].shape == (case["n_samples"], 3)
    lb = np.broadcast_to(case.get("LB", -np.inf), (3,))
    ub = np.broadcast_to(case.get("UB", np.inf), (3,))
    assert np.all(rt["samples"] >= lb) and np.all(rt["samples"] <= ub)
    _check_state(st, sj, lb == ub)


@pytest.mark.parametrize("name", ["cw", "rd", "cw_thin_log_prior"])
def test_chain_continued_through_state_equals_the_jax_chain(name, runs):
    """``state=`` continues each chain (burn 0 by default) from where it
    stopped, with its widths and its stream."""
    rt, st, rj, sj = runs[name]
    case = {k: v for k, v in CASES[name].items() if k not in ("burn",)}
    case["n_samples"] = 8
    rj2, sj2 = JDS.sample(j_gauss, X0, None, state=sj, **_kw(case, "jax"))
    # A copy of the stream, so that the state in the fixture stays as it was.
    st = st._replace(stream=JaxReplay(st.stream.key))
    rt2, st2 = TDS.sample(t_gauss, X0, None, state=st, **_kw(case, "torch"))
    _check(rt2, rj2)
    lb = np.broadcast_to(case.get("LB", -np.inf), (3,))
    _check_state(st2, sj2, lb == np.broadcast_to(case.get("UB", np.inf), (3,)))


def test_shrink_cap_exits_keep_the_point():
    """At ``max_shrink`` 2 and wide brackets many moves end at the cap;
    the chain then keeps its point, so consecutive samples repeat."""
    rt = TDS.sample(t_gauss, X0, 3, widths=50.0, LB=-100.0, UB=100.0, burn=0,
                    n_samples=30, adaptive=False, max_shrink=2, diagnostics=False)[0]
    s = rt["samples"]
    assert np.any(np.all(s[1:] == s[:-1], axis=1))


@pytest.mark.parametrize("move", ["cw", "rd"])
def test_chains_equal_the_jax_chains(move):
    """``sample_chains`` with B = 3: each chain on its own split of the
    key, as the JAX package's vmapped chains."""
    x0s = np.array([[0.2, 0.2, 0.2], [0.0, 1.0, -1.0], [1.0, -1.0, 2.0]])
    kw = dict(widths=[1.0, 1.5, 2.0], LB=-4.0, UB=5.0, n_samples=12, thin=2, burn=6,
              move=move)
    xj, fj = JDS.sample_chains(j_gauss, x0s, jax.random.key(SEED), **kw)
    xt, ft, nt, st = TDS.sample_chains(t_gauss, x0s, replay(SEED), **kw)
    assert xt.shape == (3, 12, 3) and ft.shape == (3, 12) and nt.shape == (3,)
    # burn 6, then 12 samples 2 sweeps apart.
    assert np.array_equal(st, [6 + 12 + 11] * 3)
    assert np.max(np.abs(xt - np.asarray(xj))) <= TOL
    assert np.max(np.abs(ft - np.asarray(fj))) <= TOL * np.max(np.abs(np.asarray(fj)))
    assert np.all(nt > 0)


def test_same_torch_seed_gives_the_same_chain():
    kw = dict(widths=1.0, LB=-4.0, UB=5.0, burn=6, n_samples=15)
    a = TDS.sample(t_gauss, X0, 123, **kw)[0]
    b = TDS.sample(t_gauss, X0, TDS.make_stream(123), **kw)[0]
    c = TDS.sample(t_gauss, X0, 124, **kw)[0]
    assert np.array_equal(a["samples"], b["samples"])
    assert a["n_evals"] == b["n_evals"]
    assert not np.array_equal(a["samples"], c["samples"])
    ca = TDS.sample_chains(t_gauss, np.tile(X0, (2, 1)), 5, move="rd", **kw)
    cb = TDS.sample_chains(t_gauss, np.tile(X0, (2, 1)), 5, move="rd", **kw)
    assert all(np.array_equal(u, v) for u, v in zip(ca, cb))
    assert not np.array_equal(ca[0][0], ca[0][1])


def test_n_evals_counts_every_density_call_beside_the_jax_count():
    """``n_evals`` is the reference's funccount: every call of ``log_f``,
    the initial density included.  The JAX package's segmented driver
    counts shrinkage proposals only (its monolithic chain, the fit's
    path at small N, counts none).  With infinite bounds and no step-out
    every proposal calls the density, so on one chain the two counts
    differ by the initial call alone."""
    calls = []

    def counted(x):
        calls.append(1)
        return t_gauss(x)

    kw = dict(widths=1.0, burn=6, n_samples=10)
    rt = TDS.sample(counted, X0, replay(SEED), **kw)[0]
    rj = JDS.sample(j_gauss, X0, jax.random.key(SEED), seg_sweeps=4, **kw)[0]
    assert rt["n_evals"] == len(calls) == rj["n_evals"] + 1
    assert JDS.sample(j_gauss, X0, jax.random.key(SEED), **kw)[0]["n_evals"] is None
    # Step-out probes and bounds: probes count, out-of-bounds proposals
    # call nothing.
    calls.clear()
    kw = dict(widths=0.1, LB=-1.0, UB=1.0, burn=4, n_samples=6, step_out=True)
    rt = TDS.sample(counted, X0, replay(SEED), **kw)[0]
    rj = JDS.sample(j_gauss, X0, jax.random.key(SEED), seg_sweeps=4, **kw)[0]
    assert rt["n_evals"] == len(calls) > rj["n_evals"] + 1


def test_a_proposal_out_of_bounds_calls_no_density():
    seen = []

    def recording(x):
        seen.append(x.numpy().copy())
        return t_gauss(x)

    TDS.sample(recording, X0, 1, widths=8.0, LB=-0.5, UB=0.6, burn=4, n_samples=8,
               move="rd")
    seen = np.array(seen)
    assert np.all(seen >= -0.5) and np.all(seen <= 0.6)


BAD = {
    "move": (dict(move="zz"), "move must be"),
    "rd_step_out": (dict(move="rd", step_out=True), "step_out is not supported"),
    "x0_outside": (dict(LB=1.0, UB=2.0), "outside the bounds"),
    "widths": (dict(widths=-1.0), "positive real numbers"),
    "thin": (dict(thin=0), "thinning factor"),
    "burn": (dict(burn=-1), "burn-in samples"),
    "start_density": (dict(LB=-1.0, UB=1.0, bad_start=True), "evaluate to a real"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_validation_messages_equal_the_jax_ones(name):
    kw, match = BAD[name]
    kw = dict(kw, n_samples=4)
    bad = kw.pop("bad_start", False)
    jf = (lambda x: -jnp.inf * jnp.sum(x**2 + 1)) if bad else j_gauss
    tf = (lambda x: -np.inf) if bad else t_gauss
    msgs = []
    for fn, f, key in ((JDS.sample, jf, jax.random.key(0)), (TDS.sample, tf, 0)):
        with pytest.raises(ValueError, match=match) as e:
            fn(f, X0, key, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_seg_arguments_are_accepted_and_change_nothing():
    kw = dict(widths=1.0, LB=-4.0, UB=5.0, burn=4, n_samples=8)
    a = TDS.sample(t_gauss, X0, 9, **kw)[0]
    b = TDS.sample(t_gauss, X0, 9, seg_sweeps=1, seg_moves=2, **kw)[0]
    assert np.array_equal(a["samples"], b["samples"])


def test_one_sweep_burn_window_keeps_the_widths():
    """A divergence from the JAX package, pinned here.  With ``burn`` 2
    the end-of-burn 5*std window holds one sweep: its spread is exactly 0,
    and the rule keeps the old widths ("keep the old width where the
    estimate is 0").  XLA fuses ``s_sq / n - (s_sum / n) ** 2`` into a
    fused multiply-add that keeps the rounding residue of x**2, so where
    that residue is positive the JAX chain takes a width of
    max(5 sqrt(r), sqrt(5 sqrt(r) w)), about 1e-4 here, which all but
    freezes that coordinate.  The port computes the rule with rounded
    products, as the JAX code reads; where the JAX residue is not
    positive the two chains keep the same widths."""
    kw = dict(widths=1.0, LB=-4.0, UB=5.0, burn=2, n_samples=10)
    _, sj = JDS.sample(j_gauss, X0, jax.random.key(0), **kw)
    _, st = TDS.sample(t_gauss, X0, replay(0), **kw)
    wj = np.asarray(sj.widths)
    frozen = wj < 1e-3
    assert frozen.any() and not frozen.all()
    assert np.all(st.widths >= 1.0)
    assert np.array_equal(st.widths[~frozen], wj[~frozen])
