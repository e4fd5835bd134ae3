"""Each cell's traffic run end to end on the CPU at a small size: the
sound program comes out ``correct`` and reports every metric the
manifest lists for it; with the timed path broken underneath it does
not; and the control, the reference in TF32 put in the program's place,
fails one of the cell's limits.

Every test here runs over every cell of ``BENCHMARK.json``.  The broken
paths are keyed by the traffic's ``kind``, so a new cell of a kind here
inherits them; a new kind brings its own in a test file of its own."""

import importlib

import numpy as np
import pytest
import torch

import gpyreg_tpu_torch as gt
from gpyreg_tpu_torch.core import nlml
from portbench import harness
from portbench.tests import tiny

GP = gt.GP


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_step_runs_and_is_correct(name, trace):
    result, checks, _ = tiny.run(name, trace=trace)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    metrics = result["metrics"]
    cell = tiny.cell(name)
    if trace:
        assert "breakdown" in result
        assert {"busy_s", "window_s"} <= set(result["device"])
        listed = {p["name"] for p in cell.per_layer}
        for key, m in metrics.items():
            assert key in listed
            assert np.isfinite(m["value"])
        # A CPU trace has no device events: every other reader reports.
        for key in listed:
            module = importlib.import_module(
                f"portbench.layer_metrics.{key.split('.')[0]}")
            if not getattr(module, "DEVICE_EVENTS_ONLY", False):
                assert key in metrics, key
    else:
        assert set(metrics) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in metrics.values())


def _shift_mean(monkeypatch):
    """An answer altered where it is produced: every predictive mean
    moved by 0.01."""
    orig = GP._group_predict

    def broken(self, x_star):
        mu, s2 = orig(self, x_star)
        return mu + 0.01, s2

    monkeypatch.setattr(GP, "_group_predict", broken)


def _half_samples(monkeypatch):
    """Half of the samples left out, the mixture taken over the rest."""
    orig = GP._group_predict

    def broken(self, x_star):
        mu, s2 = orig(self, x_star)
        h = mu.shape[1] // 2
        return (np.concatenate([mu[:, :h], mu[:, :h]], 1),
                np.concatenate([s2[:, :h], s2[:, :h]], 1))

    monkeypatch.setattr(GP, "_group_predict", broken)


def _half_lanes(monkeypatch):
    """Half of the batch of vectors evaluated, its results repeated for
    the rest."""
    orig = nlml.value_and_grad

    def broken(fn, hyp, X):
        h = hyp.shape[0] // 2
        v, g = orig(fn, hyp[:h], X)
        return torch.cat([v, v]), torch.cat([g, g])

    monkeypatch.setattr(nlml, "value_and_grad", broken)


def _shift_value(monkeypatch):
    """An answer altered: every NLML value 1% off."""
    orig = nlml.value_and_grad

    def broken(fn, hyp, X):
        v, g = orig(fn, hyp, X)
        return v * 1.01, g

    monkeypatch.setattr(nlml, "value_and_grad", broken)


def _stale_posterior(monkeypatch):
    """A step that returns its state unchanged: a rebuild keeps the
    posteriors it had."""
    orig = GP._compute_posteriors
    kept = {}

    def broken(self, hyp_arr):
        if id(self) not in kept:
            kept[id(self)] = orig(self, hyp_arr)
        return kept[id(self)]

    monkeypatch.setattr(GP, "_compute_posteriors", broken)


def _half_posterior(monkeypatch):
    """Half of the samples built, their posteriors repeated for the rest."""
    orig = GP._compute_posteriors

    def broken(self, hyp_arr):
        h = len(hyp_arr) // 2
        posts = orig(self, hyp_arr[:h])
        return posts + posts

    monkeypatch.setattr(GP, "_compute_posteriors", broken)


def _scaled_alpha(monkeypatch):
    """An answer altered: every alpha 1% off."""
    orig = GP._compute_posteriors

    def broken(self, hyp_arr):
        posts = orig(self, hyp_arr)
        for p in posts:
            p.alpha = p.alpha * 1.01
        return posts

    monkeypatch.setattr(GP, "_compute_posteriors", broken)


FAULTS = {
    "predict": [_shift_mean, _half_samples],
    "nlml_grad": [_shift_value, _half_lanes],
    "posterior": [_stale_posterior, _half_posterior, _scaled_alpha],
}
CASES = [(n, f) for n in tiny.CELLS
         for f in FAULTS.get(harness.Cell(tiny.ROOT, n).traffic["kind"], [])]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in CASES])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, checks, _ = tiny.run(name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_a_limit(name):
    # At a size the CPU holds in a test: the configuration's widths,
    # fewer rows (``portbench/small/<config>.json``).
    c = tiny.cell(name, sizes="control")
    result, checks, ctl = tiny.run(name, control=True, c=c)
    assert result["correct"], checks
    # The harness's own verdict on the control, through the same limits.
    assert ctl["correct"] is False, ctl["checks"]
    assert any(v["value"] > v["limit"] for v in ctl["checks"].values())
