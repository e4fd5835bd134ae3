"""The readings a cell on several cards takes per card, on made-up
traces: on one card ``idle_share``, ``mfu``, ``busy_s`` and the peak
memory are bitwise what the one-card arithmetic gives; on four cards,
one busy twice as long as the others, ``idle_share`` and ``busy_s`` are
the means over the cards, with the per-card lists beside them, the peak
is the fullest card's, and ``mfu`` is over four cards' peak."""

import types

import pytest
import torch

from portbench import devtrace, harness
from portbench.layer_metrics import idle_share, mfu
from portbench.work.peaks import FP32_FLOPS_PER_S

# Two steps, [0, 1000] and [2000, 3000] us.
STEPS = [("portbench.step", 0.0, 1000.0), ("portbench.step", 2000.0, 3000.0)]
# (category, start, end) of one card's events: overlapping kernels, a copy,
# a set, and a kernel outside the steps, which no reading counts.
ONE_CARD = [("kernel", 10.0, 300.5), ("kernel", 200.25, 410.0),
            ("gpu_memcpy", 500.0, 530.0), ("gpu_memset", 2100.0, 2117.75),
            ("kernel", 2200.0, 2900.0), ("kernel", 1200.0, 1800.0)]


def _trace(cards):
    """A trace of the steps and of ``cards[i]``'s events on card i."""
    events = [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in STEPS]
    for i, card in enumerate(cards):
        events += [{"cat": cat, "name": f"k{i}", "ts": a, "dur": b - a,
                    "args": {"device": i, "stream": 7}}
                   for cat, a, b in card]
    return devtrace.Trace(events)


def _ctx(tr, chips):
    """Ten unprofiled steps of 0.004 s, 3e9 operations each; two profiled."""
    records = [{"flops": 3e9}] * 10
    return types.SimpleNamespace(cell=types.SimpleNamespace(chips=chips),
                                 records=records, window_s=0.04,
                                 traced=records[:2], trace=tr)


def _one_card_arithmetic(tr, ctx):
    """(idle_share, mfu, busy_s) as the one-card harness computed them:
    the union of every device event in the steps."""
    busy_us = devtrace.union_us((a, b) for _, a, b in tr.in_steps())
    wall = ctx.window_s / len(ctx.records) * len(ctx.traced)
    flops = sum(r["flops"] for r in ctx.records)
    return (100.0 * (1.0 - busy_us / 1e6 / wall),
            100.0 * flops / ctx.window_s / FP32_FLOPS_PER_S,
            busy_us / 1e6)


def _device(chips, peaks, tr):
    cell = types.SimpleNamespace(chips=chips)
    return harness._device(cell, harness.cell_devices("cpu", chips), peaks, tr)


def test_one_card_reads_bitwise_as_before():
    tr = _trace([ONE_CARD])
    ctx = _ctx(tr, 1)
    idle, util, busy_s = _one_card_arithmetic(tr, ctx)
    assert idle_share.read(ctx) == idle
    assert mfu.read(ctx) == util
    dev = _device(1, [51203283968], tr)
    assert dev["busy_s"] == busy_s and dev["busy_s_per_device"] == [busy_s]
    assert dev["memory_peak_bytes"] == 51203283968
    assert dev["memory_peak_bytes_per_device"] == [51203283968]
    assert dev["window_s"] == 2000.0 / 1e6 and dev["count"] == 1


def test_an_event_without_a_device_index_is_the_first_cards():
    events = [{"cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in STEPS]
    events.append({"cat": "kernel", "name": "k", "ts": 10.0, "dur": 90.0})
    tr = devtrace.Trace(events)
    assert tr.busy_us(0) == 90.0 and tr.busy_us(1) == 0.0


# Four cards: 400 us busy in the steps on cards 0-2, twice that on card 3.
CARD = [("kernel", 100.0, 300.0), ("gpu_memcpy", 400.0, 450.0),
        ("kernel", 2100.0, 2250.0)]
TWICE = [("kernel", 100.0, 500.0), ("gpu_memcpy", 600.0, 700.0),
         ("kernel", 2100.0, 2400.0)]


def test_four_cards_read_per_card():
    tr = _trace([CARD, CARD, CARD, TWICE])
    assert [tr.busy_us(i) for i in range(4)] == [400.0, 400.0, 400.0, 800.0]
    # The union over all cards reads card 3 alone: one busy card is not a
    # busy machine.
    assert devtrace.union_us((a, b) for _, a, b in tr.in_steps()) == 800.0

    ctx = _ctx(tr, 4)
    # Over 2 steps of 0.004 s: idle 95% on cards 0-2, 90% on card 3.
    assert idle_share.read(ctx) == pytest.approx((3 * 95.0 + 90.0) / 4)
    assert mfu.read(ctx) == pytest.approx(100.0 * 3e10 / 0.04 / (4 * 67e12))

    peaks = [17_200_000_000, 17_300_000_000, 17_250_000_000, 18_000_000_000]
    dev = _device(4, peaks, tr)
    assert dev["count"] == 4
    assert dev["busy_s_per_device"] == pytest.approx([4e-4, 4e-4, 4e-4, 8e-4])
    assert dev["busy_s"] == pytest.approx(5e-4)
    assert dev["memory_peak_bytes"] == 18_000_000_000
    assert dev["memory_peak_bytes_per_device"] == peaks


def test_a_card_that_ran_nothing_is_idle():
    tr = _trace([CARD])
    assert idle_share.read(_ctx(tr, 4)) == pytest.approx((95.0 + 300.0) / 4)
    assert _device(4, [1, 0, 0, 0], tr)["busy_s_per_device"] == pytest.approx(
        [4e-4, 0.0, 0.0, 0.0])


def test_cell_devices_are_the_first_cards_or_the_cpu():
    assert harness.cell_devices("cuda", 4) == [torch.device("cuda", i)
                                                for i in range(4)]
    assert harness.cell_devices("cuda", 1) == [torch.device("cuda", 0)]
    assert harness.cell_devices("cpu", 4) == [torch.device("cpu")] * 4
