"""The port's spans (``gpyreg_tpu_torch/tracing.py``) on the CPU: none
costs a ``record_function`` without a profiler; under ``torch.profiler``
each layer boundary and host sync of the paths the benchmark's cells run
shows as its span, as often as the code crosses it; ``phase`` keeps the
fit timings' meaning."""

import time

import numpy as np
import pytest
import torch

import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch import gp as gp_module
from gpyreg_tpu_torch import tracing
from gpyreg_tpu_torch.ops import linalg as TL

torch.set_num_threads(1)

N, D, S = 40, 2, 3


def _gp(S=S):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.normal(size=(N, 1))
    H = np.zeros((S, D + 3))
    H[:, D + 1] = np.log(0.1)
    H += 0.05 * rng.normal(size=H.shape)
    g = gt.GP(D, gt.covariance_functions.SquaredExponential(),
              gt.mean_functions.ConstantMean(),
              gt.noise_functions.GaussianNoise(constant_add=True),
              device="cpu")
    g.update(X_new=X, y_new=y, hyp=H)
    return g, H


def _traced(fn):
    """(fn(), [(name, start, end)] of the ``gpyreg.`` spans it opened)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("gpyreg.")]
    return out, spans


def _names(spans):
    return [n for n, _, _ in spans]


def _inside(spans, outer):
    """The spans that lie within ``outer``'s interval."""
    _, a, b = outer
    return [s for s in spans if s is not outer and a <= s[1] and s[2] <= b]


def _syncs(spans):
    return [n for n in _names(spans) if n.startswith("gpyreg.sync.")]


def test_no_span_costs_a_record_function_without_a_profiler(monkeypatch):
    g, H = _gp()
    fns, args = g._obj_args()

    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("gpyreg.a") is tracing.span("gpyreg.b")
    g.predict(np.zeros((5, D)))
    g.update(hyp=H + 0.01)
    v, grad = fns["nlz_grad"](H, *args)
    assert v.shape == (S,) and grad.shape == (S, D + 3)
    timings = {}
    with tracing.phase(timings, "design_s"):
        pass
    assert set(timings) == {"design_s"}


@pytest.mark.parametrize("B", [1, 3])
def test_nlz_grad_has_a_lane_a_vector_and_two_syncs_each(B):
    """Each lane's two retry checks, and the vectors' one copy to the
    device before the lanes."""
    g, H = _gp(S=B)
    fns, args = g._obj_args()
    _, spans = _traced(lambda: fns["nlz_grad"](H, *args))
    lanes = [s for s in spans if s[0] == "gpyreg.nlml.lane"]
    assert len(lanes) == B
    for lane in lanes:
        inner = _names(_inside(spans, lane))
        assert inner.count("gpyreg.nlml.forward") == 1
        assert inner.count("gpyreg.nlml.backward") == 1
        for name in ("gpyreg.assemble", "gpyreg.chol", "gpyreg.solve",
                     "gpyreg.chol_inverse"):
            assert inner.count(name) == 1, name
        fwd = next(s for s in _inside(spans, lane)
                   if s[0] == "gpyreg.nlml.forward")
        bwd = next(s for s in _inside(spans, lane)
                   if s[0] == "gpyreg.nlml.backward")
        assert "gpyreg.chol" in _names(_inside(spans, fwd))
        assert "gpyreg.chol_inverse" in _names(_inside(spans, bwd))
    assert sorted(_syncs(spans)) == sorted(
        ["gpyreg.sync.chol_retry", "gpyreg.sync.chol_failed"] * B
        + ["gpyreg.sync.grad_hyp"])
    (copy,) = [s for s in spans if s[0] == "gpyreg.sync.grad_hyp"]
    assert copy[2] <= min(a for _, a, _ in lanes)
    assert "gpyreg.chol.retry" not in _names(spans)


def test_a_stack_without_gradient_has_a_lane_a_vector():
    g, H = _gp()
    _, spans = _traced(lambda: g._objective_batch(H))
    names = _names(spans)
    assert names.count("gpyreg.nlml.lane") == S
    assert _syncs(spans).count("gpyreg.sync.objective_batch") == 1
    assert _syncs(spans).count("gpyreg.sync.stack_hyp") == 1


# The objective's pulls, one each: (site, call on the GP and a vector).
PULLS = {
    "objective": ("objective", lambda g, h: g._objective(h)),
    "objective_grad": ("objective", lambda g, h: g._objective(h, grad=True)),
    "log_likelihood": ("log_likelihood", lambda g, h: g.log_likelihood(h)),
    "log_likelihood_grad": ("log_likelihood",
                            lambda g, h: g.log_likelihood(h, True)),
    "log_prior": ("log_prior",
                  lambda g, h: g._GP__compute_log_priors(h, False)),
    "log_prior_grad": ("log_prior",
                       lambda g, h: g._GP__compute_log_priors(h, True)),
}


@pytest.mark.parametrize("case", sorted(PULLS))
def test_each_objective_pull_is_one_sync(case):
    g, H = _gp()
    g.set_priors({"covariance_log_lengthscale": ("gaussian", (0.0, 1.5)),
                  "covariance_log_outputscale": None,
                  "noise_log_scale": None, "mean_const": None})
    g._obj_args()
    site, call = PULLS[case]
    _, spans = _traced(lambda: call(g, H[0]))
    assert _syncs(spans).count(f"gpyreg.sync.{site}") == 1


def test_predict_has_a_chunk_span_a_chunk_and_one_mixture(monkeypatch):
    g, _ = _gp()
    M, chunk = 20, 7
    monkeypatch.setattr(gp_module, "_PREDICT_CHUNK_ELEMS", N * chunk)
    (mu, s2), spans = _traced(lambda: g.predict(np.zeros((M, D))))
    assert mu.shape == s2.shape == (M, 1)
    names = _names(spans)
    chunks = -(-M // chunk)
    assert names.count("gpyreg.predict.chunk") == S * chunks
    assert names.count("gpyreg.predict.sample") == S
    assert names.count("gpyreg.predict") == 1
    assert names.count("gpyreg.predict.mixture") == 1
    # The points' copy to the device, a chunk's copy of its sample's
    # hyperparameters, and the one pull of the moments.
    assert _syncs(spans) == (["gpyreg.sync.points"]
                             + ["gpyreg.sync.chunk_hyp"] * (S * chunks)
                             + ["gpyreg.sync.predict"])
    for chunk in (s for s in spans if s[0] == "gpyreg.predict.chunk"):
        assert _syncs(_inside(spans, chunk)) == ["gpyreg.sync.chunk_hyp"]
    (predict,) = [s for s in spans if s[0] == "gpyreg.predict"]
    assert len(_inside(spans, predict)) == len(spans) - 1
    mixture = next(s for s in spans if s[0] == "gpyreg.predict.mixture")
    assert _inside(spans, mixture) == []


def test_rebuild_has_its_batches_and_finalizations():
    g, H = _gp()
    _, spans = _traced(lambda: g.update(hyp=H + 0.01))
    names = _names(spans)
    assert names.count("gpyreg.update.full") == 1
    batches = names.count("gpyreg.posterior.batch")
    assert batches >= 1
    assert names.count("gpyreg.posterior.finalize") == batches
    assert names.count("gpyreg.chol") == batches
    assert names.count("gpyreg.solve") == batches
    assert names.count("gpyreg.assemble") == S
    # The data's copies (X and y), then a batch's copy of its
    # hyperparameters, its two retry checks, the one pull of _post_small
    # and the copies of its scales (sW and the factors' scaling).
    assert sorted(_syncs(spans)) == sorted(
        ["gpyreg.sync.data"] * 2
        + ["gpyreg.sync.stack_hyp", "gpyreg.sync.chol_retry",
           "gpyreg.sync.chol_failed", "gpyreg.sync.posterior"] * batches
        + ["gpyreg.sync.scales"] * (2 * batches))


def test_rank_one_update_has_a_sample_span_and_one_read_each():
    g, _ = _gp()
    x, y = np.full((1, D), 0.3), np.full((1, 1), 0.2)
    _, spans = _traced(lambda: g.update(X_new=x, y_new=y))
    names = _names(spans)
    assert names.count("gpyreg.update.rank1") == 1
    assert "gpyreg.update.full" not in names
    assert names.count("gpyreg.rank1.sample") == S
    assert _syncs(spans) == ["gpyreg.sync.rank1_ok"] * S


def _indefinite(n, neg, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.concatenate([[-neg], rng.uniform(1.0, 2.0, size=n - 1)])
    return (Q * lam) @ Q.T


@pytest.mark.parametrize("neg,rounds", [(-0.5, 0), (5e-3, 1), (0.5, 3)],
                         ids=["none", "one", "three"])
def test_escalation_opens_a_retry_span_a_round(neg, rounds):
    K = torch.tensor(_indefinite(24, neg, 1))
    sn2 = torch.full((24,), 1e-3, dtype=torch.float64)
    (_, mult), spans = _traced(lambda: TL.jittered_cholesky(K, sn2))
    assert mult.item() == 10.0 ** rounds
    names = _names(spans)
    assert names.count("gpyreg.chol") == 1
    assert names.count("gpyreg.chol.retry") == rounds
    assert _syncs(spans).count("gpyreg.sync.chol_retry") == rounds + 1
    assert _syncs(spans).count("gpyreg.sync.chol_rows") == rounds
    assert _syncs(spans).count("gpyreg.sync.chol_failed") == 1


def test_phase_counts_each_second_once():
    timings = {"design_s": 1.0}
    t0 = time.perf_counter()
    with tracing.phase(timings, "optimize_s"):
        time.sleep(0.02)
        with tracing.phase(timings, "rank_s"):
            time.sleep(0.05)
    wall = time.perf_counter() - t0
    assert timings["rank_s"] >= 0.05 and timings["optimize_s"] >= 0.02
    # The outer phase's seconds less the inner's: the wall counted once.
    assert timings["optimize_s"] + timings["rank_s"] == pytest.approx(
        wall, abs=1e-3)
    assert timings["design_s"] == 1.0
    _, spans = _traced(lambda: _phases({}))
    (outer,) = [s for s in spans if s[0] == "gpyreg.fit.sample"]
    assert _names(_inside(spans, outer)) == ["gpyreg.fit.posterior"]


def test_phase_adds_to_a_key_it_meets_again():
    timings = {}
    for pause in (0.02, 0.03):
        with tracing.phase(timings, "design_s"):
            time.sleep(pause)
    assert list(timings) == ["design_s"] and timings["design_s"] >= 0.05


def test_the_phases_of_a_fit_follow_on():
    timings = tracing.Timings()
    made = timings.mark
    with tracing.phase(timings, "design_s"):
        time.sleep(0.01)
    time.sleep(0.02)  # host work between two phases
    with tracing.phase(timings, "optimize_s"):
        with tracing.phase(timings, "rank_s"):
            time.sleep(0.01)
    # The gap counts in the later phase, a nested phase does not follow
    # on from its outer one, and the phases add up to the whole time.
    assert timings["optimize_s"] >= 0.02 and timings["rank_s"] >= 0.01
    assert sum(timings.values()) == pytest.approx(timings.mark - made,
                                                  rel=1e-12)


def _phases(timings):
    with tracing.phase(timings, "sample_s"):
        with tracing.phase(None, "posterior_s"):
            pass
    return timings
