"""The port's host ``SliceSampler`` and diagnostics against the JAX
package's (``gpyreg_tpu.slice_sample``), under one ``np.random.seed``:
the same chain to 1e-12, for a Gaussian, a bounded exponential, a fixed
dimension, step-out, ``width_base=False``, thinning and burn-in, the
Metropolis step and a chain continued over two calls; ``gelman_rubin``,
``effective_n`` and ``device_slice.diagnose`` to 1e-12; and the same
validation messages.  Both sides are numpy on the host, so the two
chains are the same arithmetic on the same draws."""

import numpy as np
import pytest

import gpyreg_tpu.inference.device_slice as JDS
import gpyreg_tpu.slice_sample as J
import gpyreg_tpu_torch.inference.device_slice as TDS
import gpyreg_tpu_torch.slice_sample as T

TOL = 1e-12

MU = np.array([0.3, -0.5, 1.0])
SD = np.array([0.5, 1.0, 2.0])


def gauss(x):
    return -0.5 * np.sum(((x - MU) / SD) ** 2)


def expo(x):
    return -1.3 * np.sum(x)


def per_point(x):
    # A density given per datapoint, which the sampler sums.
    return np.array([-0.5 * x[0] ** 2, -0.5 * (x[1] - 1.0) ** 2])


CASES = {
    "gauss": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], N=40),
    "gauss_widths_burn": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], widths=[1.0, 2.0, 0.5],
                              N=30, burn=12),
    "exponential_bounded": dict(log_f=expo, x0=[1.0], LB=0.0, UB=6.0, N=40),
    "fixed_dimension": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], LB=[-3.0, 0.2, -5.0],
                            UB=[3.0, 0.2, 5.0], N=30),
    "step_out": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], widths=0.05, N=20, burn=6,
                     options={"step_out": True}),
    "width_base_false": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], widths=[1.0, 2.0, 0.5],
                             N=30, burn=10, options={"width_base": False}),
    "thin": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], N=15, thin=3, burn=5),
    "not_adaptive": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], N=20,
                         options={"adaptive": False}),
    "per_point": dict(log_f=per_point, x0=[0.0, 0.0], LB=-4.0, UB=4.0, N=25),
    "log_prior": dict(log_f=gauss, x0=[0.1, 0.2, 0.3], N=20,
                      options={"log_prior": lambda x: -0.1 * np.sum(x**2)}),
}


def _metropolis_rnd():
    return np.random.normal(size=3)


def _metropolis_pdf(x):
    return float(np.exp(-0.5 * np.sum(x**2)))


CASES["metropolis"] = dict(log_f=gauss, x0=[0.1, 0.2, 0.3], N=20,
                           options={"metropolis_rnd": _metropolis_rnd,
                                    "metropolis_pdf": _metropolis_pdf})


def _run(mod, case, seed=3):
    c = dict(case)
    opts = {"display": "off", **c.get("options", {})}
    np.random.seed(seed)
    s = mod.SliceSampler(c["log_f"], np.array(c["x0"]), c.get("widths"), c.get("LB"),
                         c.get("UB"), opts)
    res = s.sample(c["N"], thin=c.get("thin", 1), burn=c.get("burn"))
    return s, res


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=TOL, atol=TOL, equal_nan=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_equals_the_jax_sampler(name):
    sj, rj = _run(J, CASES[name])
    u_j = np.random.rand()
    st, rt = _run(T, CASES[name])
    u_t = np.random.rand()
    assert sorted(rt) == sorted(rj)
    for k in ("samples", "f_vals", "log_priors", "R", "eff_N"):
        _same(rt[k], rj[k])
    assert rt["exit_flag"] == rj["exit_flag"]
    assert st.func_count == sj.func_count > 0
    _same(st.widths, sj.widths)
    assert u_t == u_j  # numpy's stream was consumed alike


def test_continued_chain_equals_the_jax_sampler():
    """A second ``sample`` call continues the chain (burn 0) on both."""
    outs = []
    for mod in (J, T):
        np.random.seed(11)
        s = mod.SliceSampler(gauss, np.array([0.1, 0.2, 0.3]), options={"display": "off"})
        outs.append([s.sample(10, burn=6)["samples"], s.sample(10)["samples"]])
    for a, b in zip(*outs):
        _same(a, b)


def test_step_out_walks_and_counts_its_probes():
    """Step-out with narrow widths widens the bracket: it costs density
    calls beyond the shrinkage proposals, counted in ``func_count`` as in
    the reference."""
    case = CASES["step_out"]
    s_on, _ = _run(T, case)
    s_off, _ = _run(T, {**case, "options": {}})
    assert s_on.func_count > s_off.func_count


@pytest.mark.parametrize("shape", [(2, 30), (3, 25, 4), (4, 10, 2)])
def test_diagnostics_equal_the_jax_ones(shape):
    rng = np.random.default_rng(sum(shape))
    chains = np.cumsum(rng.normal(size=shape), axis=1) * 0.3 + rng.normal(size=shape)
    _same(T.gelman_rubin(chains), J.gelman_rubin(chains))
    _same(T.gelman_rubin(chains, return_var=True), J.gelman_rubin(chains, return_var=True))
    _same(T.effective_n(chains), J.effective_n(chains))


@pytest.mark.parametrize("n", [3, 8, 41])
def test_diagnose_equals_the_jax_one(n):
    rng = np.random.default_rng(n)
    samples = np.cumsum(rng.normal(size=(n, 3)), axis=0)
    ft, Rt, et = TDS.diagnose(samples)
    fj, Rj, ej = JDS.diagnose(samples)
    assert ft == fj
    _same(Rt, Rj)
    _same(et, ej)


def test_diagnostics_refuse_a_single_chain():
    for fn in (T.gelman_rubin, T.effective_n):
        with pytest.raises(ValueError, match="multiple chains"):
            fn(np.zeros((1, 5)))


BAD = {
    "x0_2d": (dict(x0=np.zeros((2, 2))), {}, "scalar or a 1D array"),
    "bounds_shape": (dict(x0=np.zeros(2), LB=np.zeros(3)), {}, "LB and UB"),
    "bounds_order": (dict(x0=np.zeros(2), LB=1.0, UB=0.0), {}, "equal or greater"),
    "complex_widths": (dict(x0=np.zeros(2), widths=np.array([1j, 1.0])), {},
                       "positive real"),
    "negative_widths": (dict(x0=np.zeros(2), widths=-1.0), {}, "positive real"),
    "x0_outside": (dict(x0=np.array([5.0, 0.0]), LB=-1.0, UB=1.0), {}, "outside the bounds"),
    "thin": (dict(x0=np.zeros(2)), dict(thin=0), "thinning factor"),
    "burn": (dict(x0=np.zeros(2)), dict(burn=-1), "burn-in samples"),
    "start_density": (dict(x0=np.zeros(2), log_f=lambda x: -np.inf), {},
                      "evaluate to a real number"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_validation_messages_equal_the_jax_ones(name):
    ctor, call, match = BAD[name]
    msgs = []
    for mod in (J, T):
        kw = dict(ctor)
        log_f = kw.pop("log_f", gauss if kw["x0"].size == 3 else lambda x: -np.sum(x**2))
        with pytest.raises(ValueError, match=match) as e:
            s = mod.SliceSampler(log_f, kw.pop("x0"), kw.get("widths"), kw.get("LB"),
                                 kw.get("UB"), {"display": "off"})
            s.sample(5, **call)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
