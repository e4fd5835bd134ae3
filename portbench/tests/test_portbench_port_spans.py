"""The readers of the port's spans, ``host_syncs`` and ``port_idle_ms``,
on a hand-built trace with known steps, gaps, spans and syncs; absent,
not 0, where the program has no spans; and on the small CPU cells, the
syncs a step that the port's code makes."""

import types

import pytest

from portbench import devtrace
from portbench.layer_metrics import host_syncs, port_idle_ms
from portbench.tests import tiny


def _ctx(spans, kernels):
    """A context over two steps, [0, 100] and [200, 300] us."""
    steps = [("portbench.step", 0, 100), ("portbench.step", 200, 300)]
    events = [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in steps + spans]
    events += [{"cat": "kernel", "name": "k", "ts": a, "dur": b - a}
               for a, b in kernels]
    return types.SimpleNamespace(trace=devtrace.Trace(events))


KERNELS = [(10, 40), (60, 90), (200, 250)]
SPANS = [
    ("gpyreg.nlml.lane", 5, 95),
    ("gpyreg.sync.chol_retry", 40, 45),
    ("gpyreg.sync.chol_failed", 50, 62),
    ("gpyreg.predict", 190, 290),  # starts before its step: clipped
    ("gpyreg.sync.predict", 240, 260),
    ("gpyreg.sync.objective", 150, 155),  # between the steps
    ("portbench.other", 92, 100),  # not the port's
]


def test_syncs_a_step_count_the_sync_spans_inside_the_steps():
    assert host_syncs.read(_ctx(SPANS, KERNELS)) == pytest.approx(3 / 2)


def test_port_idle_is_the_idle_time_the_port_spans_cover():
    # Step 1 idles over [0, 10], [40, 60], [90, 100]; the lane covers
    # [5, 10], [40, 60], [90, 95]: 30 us.  Step 2 idles over [250, 300];
    # predict covers [250, 290]: 40 us.  (30 + 40) / 2 steps, in ms.
    assert port_idle_ms.read(_ctx(SPANS, KERNELS)) == pytest.approx(0.035)


def test_a_span_over_busy_time_leaves_no_idle():
    spans = [("gpyreg.chol", 10, 40), ("gpyreg.chol", 200, 250)]
    assert port_idle_ms.read(_ctx(spans, KERNELS)) == 0.0
    assert host_syncs.read(_ctx(spans, KERNELS)) == 0.0


@pytest.mark.parametrize("spans", [
    [],
    [("portbench.other", 5, 95), ("portbench.other", 205, 295)],
    [("gpyreg.nlml.lane", 5, 95)],  # the second step has none
], ids=["none", "others", "one_step"])
def test_no_port_span_in_a_step_reads_absent(spans):
    ctx = _ctx(spans, KERNELS)
    assert host_syncs.read(ctx) is None
    assert port_idle_ms.read(ctx) is None


# The port's syncs a step on these small cells (a cell added later
# brings its own count in a test of its own): two retry checks a lane
# (B = 4 lanes) and the vectors' copy to the device; a request's copy of
# its points, a chunk's copy of its sample's hyperparameters (S = 4
# samples, one chunk each) and the one pull; a build's copies of X and
# y, of its stack's hyperparameters and of two scales, the two retry
# checks on its stack and its one pull of the per-sample scalars.
SYNCS = {"d8.nlml_grad": 9.0, "config5.predict": 6.0,
         "config5.posterior": 8.0}


@pytest.mark.parametrize("name", SYNCS)
def test_small_cells_report_the_port_spans(name):
    result, checks, _ = tiny.run(name, trace=1)
    assert result["correct"], checks
    metrics = result["metrics"]
    part = name.split(".")[1]
    assert metrics[f"host_syncs.{part}"]["value"] == SYNCS[name]
    assert metrics[f"port_idle_ms.{part}"]["value"] > 0
