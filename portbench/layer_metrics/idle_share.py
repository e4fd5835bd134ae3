"""Device idle share of a step, in %: for each of the cell's cards, 1 -
its busy time in the profiled steps (the union of its kernel, memcpy and
memset intervals) over the host-clock time of as many steps of the
unprofiled window; the mean over the cards.  The profiler stretches the
host's part of a step, so the unprofiled steps give the denominator.  A
card that ran nothing counts as idle: one busy card is not a busy
machine."""


def read(ctx):
    if not ctx.traced:
        return None
    wall = ctx.window_s / len(ctx.records) * len(ctx.traced)
    shares = [100.0 * (1.0 - ctx.trace.busy_us(i) / 1e6 / wall)
              for i in range(ctx.cell.chips)]
    return sum(shares) / len(shares)
