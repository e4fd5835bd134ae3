"""Roofline share of one hand-written kernel over the profiled steps: the
summed least time of its launches (shapes from the steps' records) over
the summed device time of its events in the trace.

Three counts of the kernel's launches must agree: the shapes the kind
lists, the events in the trace, and the port's own counter
(``ctx.launches``, keys ``counter_keys``).  A kernel that none of the
trace and the counter saw is off the path, and nothing is read.  Any
other disagreement raises: the shapes would no longer be the work the
kernel did, and the share would be wrong, not absent."""


def share(ctx, metric, launch_names, extra_names, counter_keys, shapes_key,
          bound):
    shapes = [s for r in ctx.traced for s in r[shapes_key]]
    events = [(n, a, b) for n, a, b in ctx.trace.in_steps()
              if any(k in n for k in launch_names + extra_names)]
    launches = [e for e in events if any(k in e[0] for k in launch_names)]
    counted = sum(ctx.launches.get(k, 0) for k in counter_keys)
    if not launches and not counted:
        return None
    if not len(shapes) == len(launches) == counted:
        raise RuntimeError(
            f"{metric}: the kind lists {len(shapes)} launches, the trace "
            f"holds {len(launches)}, the port counted {counted}")
    busy = sum(b - a for _, a, b in events) / 1e6
    return 100.0 * sum(bound(*s) for s in shapes) / busy
