"""Device ms a step of the copies between cards: the ``Memcpy PtoP``
events that start inside the profiled step spans, their durations summed
over the cards, per the step's ``norm`` (one build).

The trace's count of those events must equal the port's own count of the
copies it made between two devices (``parallel.mesh.PEER_COPIES``, which
the kind records a step as ``peer_copies``); any disagreement raises, for
the time would no longer be of the copies the port made.  None where the
kind recorded no count (a program without the counter) or where neither
the trace nor the counter saw a copy."""

DEVICE_EVENTS_ONLY = True

PEER = "PtoP"


def read(ctx):
    counted = [r.get("peer_copies") for r in ctx.traced]
    if not counted or any(c is None for c in counted):
        return None
    events = [(n, a, b) for n, a, b in ctx.trace.in_steps() if PEER in n]
    if not events and not sum(counted):
        return None
    if len(events) != sum(counted):
        raise RuntimeError(
            f"peer_copy_ms: the trace holds {len(events)} peer copies, the "
            f"port counted {sum(counted)}")
    norm = sum(r["norm"] for r in ctx.traced)
    return sum(b - a for _, a, b in events) / 1e3 / norm
