"""The roofline readers on a made-up trace: launch counts that agree
give the share, a kernel off the path gives nothing, and counts that
disagree raise rather than drop the metric."""

import types

import pytest

from portbench.layer_metrics import tile_roofline, vjp_roofline
from portbench.work import kernel_tile, kernel_vjp

SELF = (4096, 4096, 8, True)


class _Trace:
    def __init__(self, events):
        self.events = events

    def in_steps(self):
        return self.events


def _ctx(shapes, names, counted, key="tiles", counter="self"):
    """Events of 40 us each, 100 us apart."""
    events = [(n, 100.0 * i, 100.0 * i + 40.0) for i, n in enumerate(names)]
    return types.SimpleNamespace(traced=[{key: shapes}], trace=_Trace(events),
                                 launches={counter: counted})


def test_agreeing_counts_give_the_share():
    ctx = _ctx([SELF] * 3, ["kernel_tile<1>"] * 3 + ["gemm"], 3)
    want = 100.0 * 3 * kernel_tile.bound_s(*SELF) / (3 * 40e-6)
    assert tile_roofline.read(ctx) == pytest.approx(want)
    # The gradient tile's reductions count in its time.
    ctx = _ctx([(4096, 8)] * 2, ["kernel_vjp<1>", "reduce_partials"] * 2, 2,
               key="vjps", counter="vjp")
    want = 100.0 * 2 * kernel_vjp.bound_s(4096, 8) / (4 * 40e-6)
    assert vjp_roofline.read(ctx) == pytest.approx(want)


def test_a_kernel_off_the_path_reads_nothing():
    assert tile_roofline.read(_ctx([SELF] * 3, ["gemm"], 0)) is None


@pytest.mark.parametrize("events,counted", [(4, 4), (3, 4), (2, 3)],
                         ids=["split", "counter_apart", "fewer"])
def test_disagreeing_counts_raise(events, counted):
    ctx = _ctx([SELF] * 3, ["kernel_tile<1>"] * events, counted)
    with pytest.raises(RuntimeError, match="tile_roofline"):
        tile_roofline.read(ctx)
