"""The whole step's share of the cell's FP32 peak, in %: the operations
the step's algorithm needs for its inputs (``portbench/work/``, summed
over the unprofiled window's steps) over the window's seconds and 67
TFLOP/s a card, times the cell's cards."""

from portbench.work.peaks import FP32_FLOPS_PER_S


def read(ctx):
    flops = sum(r["flops"] for r in ctx.records)
    if flops <= 0:
        return None
    return 100.0 * flops / ctx.window_s / (ctx.cell.chips * FP32_FLOPS_PER_S)
