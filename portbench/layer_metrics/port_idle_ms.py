"""Device-idle ms a step inside the port: within each profiled step span,
the time in which the device ran nothing (the complement of the union of
its kernel, memcpy and memset intervals, ``devtrace.Trace.in_steps``)
and which the union of the port's ``gpyreg.`` spans covers, over the
number of profiled steps.  Beside ``idle_share`` it splits the idle time
that the port's own code leaves from the harness's, around its calls.
None when a profiled step holds no ``gpyreg.`` span at all."""

from portbench import devtrace

PORT = "gpyreg."


def _overlap_us(xs, ys):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    tr = ctx.trace
    if not tr.steps:
        return None
    busy = devtrace.merged((a, b) for _, a, b in tr.in_steps())
    idle_us = 0.0
    for s, e in tr.steps:
        port = devtrace.merged((max(a, s), min(b, e)) for n, a, b in tr.spans
                               if n.startswith(PORT) and a < e and b > s)
        if not port:
            return None
        idle_us += devtrace.union_us(port) - _overlap_us(port, busy)
    return idle_us / 1e3 / len(tr.steps)
