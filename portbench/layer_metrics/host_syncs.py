"""Host syncs a step: the port's ``gpyreg.sync.<site>`` spans that start
inside the profiled step spans, over the number of profiled steps.  The
port opens one such span at each place where the host waits for a device
value (a ``bool``, ``float`` or ``int`` of a device tensor, a ``.cpu()``
or ``.tolist()``) or copies a host array to the device (a copy from
pageable memory waits for the queued work), so the count is its host-sync
counter; a sync inside a torch operator is not counted.  None when a profiled step holds no
``gpyreg.`` span at all: a program without the spans reads as absent,
not as 0."""

PORT = "gpyreg."
SYNC = "gpyreg.sync."


def read(ctx):
    tr = ctx.trace
    if not tr.steps:
        return None
    syncs = 0
    for s, e in tr.steps:
        names = [n for n, a, _ in tr.spans
                 if n.startswith(PORT) and s <= a <= e]
        if not names:
            return None
        syncs += sum(n.startswith(SYNC) for n in names)
    return syncs / len(tr.steps)
