"""The device trace of a traced run: ``torch.profiler`` over a few steps,
its Chrome trace read back into device intervals and the benchmark's
spans, and the arithmetic the readers share.

Device busy time is the union of the intervals of the ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events (device events only, so an
operator and the kernels under it are never counted twice), the
arithmetic of ``tools/profile_torch_slice.py``'s ``_union_us``, taken
per device: each device event keeps its card's index (the trace's
``args.device``), and a cell on several cards reads each card's busy
time apart, so that one busy card never counts as a busy machine.
"""

import json
import os
import tempfile

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_SPAN = "portbench.step"


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


class Trace:
    """Events of one profiled window, in microseconds: ``device`` (name,
    start, end) on every card, ``per_device`` (the same rows by the
    card's index), ``spans`` (the benchmark's ``record_function`` spans),
    ``ops`` (host operators) and ``steps`` (the step spans)."""

    def __init__(self, events):
        def row(e):
            return (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))

        def rows(cats):
            return [row(e) for e in events if e.get("cat") in cats and "dur" in e]

        self.device, self.per_device = [], {}
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                self.device.append(row(e))
                index = int(e.get("args", {}).get("device", 0))
                self.per_device.setdefault(index, []).append(row(e))
        self.spans = rows(("user_annotation",))
        self.ops = rows(("cpu_op",))
        self.steps = sorted((a, b) for n, a, b in self.spans if n == STEP_SPAN)

    def in_steps(self, device=None):
        """Device events that start inside a step span: on every card, or
        on the card of index ``device``."""
        rows = self.device if device is None else self.per_device.get(device, [])
        return [(n, a, b) for n, a, b in rows
                if any(s <= a <= e for s, e in self.steps)]

    def busy_us(self, device):
        """The busy time of the card of index ``device`` in the steps."""
        return union_us((a, b) for _, a, b in self.in_steps(device))

    def window_us(self):
        return sum(b - a for a, b in self.steps)

    def device_ops(self, top=10):
        """[(name, seconds)] of the device events that took most time."""
        total = {}
        for n, a, b in self.in_steps():
            total[n[:120]] = total.get(n[:120], 0.0) + (b - a)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n, us / 1e6] for n, us in ranked]

    def _innermost(self, rows, t):
        best = None
        for n, a, b in rows:
            if a <= t <= b and (best is None or b - a < best[2] - best[1]):
                best = (n, a, b)
        return None if best is None else best[0]

    def idle_gaps(self, top=10):
        """[(what the host was doing, seconds)] of the longest stretches of
        each step span in which the device ran nothing: the innermost
        benchmark span and host operator at the gap's middle."""
        busy = merged((a, b) for _, a, b in self.in_steps())
        gaps = []
        for s, e in self.steps:
            t = s
            for a, b in busy:
                if b <= s or a >= e:
                    continue
                if a > t:
                    gaps.append((t, a))
                t = max(t, b)
            if e > t:
                gaps.append((t, e))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            span = self._innermost(self.spans, mid) or "none"
            op = self._innermost(self.ops, mid) or "python"
            out.append([f"{span}/{op}", (b - a) / 1e6])
        return out


def capture(run, platform):
    """Run ``run()`` under the profiler, which traces every card of the
    process, and return its :class:`Trace`.  The Chrome trace goes to a
    temporary file, which is removed once it is read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if platform == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
