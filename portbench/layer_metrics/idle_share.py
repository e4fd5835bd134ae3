"""Device idle share of a step, in %: 1 - the device's busy time in the
profiled steps (the union of their kernel, memcpy and memset intervals)
over the host-clock time of as many steps of the unprofiled window.  The
profiler stretches the host's part of a step, so the unprofiled steps
give the denominator."""


def read(ctx):
    if not ctx.traced:
        return None
    wall = ctx.window_s / len(ctx.records) * len(ctx.traced)
    return 100.0 * (1.0 - ctx.trace.busy_us() / 1e6 / wall)
