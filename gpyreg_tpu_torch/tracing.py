"""Spans of the port's layers, recorded by ``torch.profiler``.

:func:`span` is ``torch.profiler.record_function(name)`` while a torch
profiler is collecting, read from torch's own flag, and one shared no-op
context otherwise: about 0.5 us a span with no profiler, where an
unguarded ``record_function`` costs about 10 us.  Tracing is therefore
on exactly when an operator or a benchmark runs ``torch.profiler``, and
the spans reach its trace as ``user_annotation`` events on the same clock
as the device events.  A span's parent is the span that encloses it on
its thread; the autograd engine carries the profiler's state onto its
own thread, so the spans of a backward pass lie, in time, inside the
``gpyreg.nlml.backward`` span that waits for them.

Every name starts with ``gpyreg.``.  ``gpyreg.sync.<site>`` is a place
where the host blocks on a device value (a ``bool``, ``float`` or
``int`` of a device tensor, an ``.item()``, ``.tolist()``, ``.cpu()`` or
``.numpy()``), or where a host array is copied to the card
(:func:`to_device`): the count of these spans is the port's host-sync
counter.  ``PERF.md`` lists every span, sync site and the metric that reads it.

:func:`phase` times one phase of a fit on the host clock, always, and
records it as the span ``gpyreg.fit.<phase>``; ``GP.fit_timings``,
``map_optimize.design_optimize``'s ``rank_s`` and ``dist_exact_fit``'s
``timings`` come from it, and :class:`Timings` makes a fit's phases
add up to its time.  :func:`profile` runs a block under the
profiler and writes its trace into a directory (``GP.fit``'s
``trace_dir``).
"""

import contextlib
import time

import torch

_OFF = contextlib.nullcontext()


def span(name):
    """A profiler span named ``name`` while a torch profiler collects,
    else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def to_device(site, a, dtype, device):
    """``a`` as a ``dtype`` tensor on ``device``.  A host array's copy
    is a sync: PyTorch's copy from pageable host memory waits for the
    work queued on the device, so it is the span ``gpyreg.sync.<site>``.
    A tensor already on ``device`` is only cast."""
    if isinstance(a, torch.Tensor) and a.device == torch.device(device):
        return a.to(dtype)
    with span("gpyreg.sync." + site):
        return torch.as_tensor(a, dtype=dtype).to(device)


class Timings(dict):
    """The seconds of a fit's phases (``GP.fit_timings``): a dict whose
    outermost phases follow on from each other, each starting where the
    last ended (the first where the dict was made), so that they add up
    to the fit's time, with the host's work between two phases counted
    in the later one."""

    def __init__(self):
        super().__init__()
        self.mark = time.perf_counter()
        self.depth = 0


@contextlib.contextmanager
def phase(timings, key):
    """Add the block's seconds to ``timings[key]`` (``key`` ends in
    ``_s``) and record it as the span ``gpyreg.fit.<key less _s>``.
    Phases nested in this one that write into the same dict are taken
    out of its time, so that no second is counted twice.  An outermost
    phase of a :class:`Timings` starts at its mark.  With ``timings``
    None the block is only a span."""
    with span("gpyreg.fit." + key.removesuffix("_s")):
        if timings is None:
            yield
            return
        before = sum(timings.values())
        clock = isinstance(timings, Timings)
        t0 = timings.mark if clock and not timings.depth else (
            time.perf_counter())
        if clock:
            timings.depth += 1
        yield
        t1 = time.perf_counter()
        nested = sum(timings.values()) - before
        timings[key] = timings.get(key, 0.0) + t1 - t0 - nested
        if clock:
            timings.depth -= 1
            if not timings.depth:
                timings.mark = t1


@contextlib.contextmanager
def profile(trace_dir, device):
    """Run the block under ``torch.profiler`` (the host, and the card's
    kernels for a CUDA ``device``) and write its trace into
    ``trace_dir``, as TensorBoard's profiler plugin reads it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(trace_dir))
    with torch.profiler.profile(activities=acts, on_trace_ready=handler):
        yield
