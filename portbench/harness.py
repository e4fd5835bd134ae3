"""The harness: runs one cell of ``BENCHMARK.json`` once and returns its
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name:

- ``BENCHMARK.json``'s ``configs`` entry names the configuration's file;
- ``portbench/traffic/<traffic>.json`` holds the mix's parameters, and
  its ``kind`` names the module ``portbench/kinds/<kind>.py`` that drives
  it;
- ``portbench/limits/<cell>.json`` holds the limits of the numbers that
  decide ``correct``;
- ``portbench/layer_metrics/<family>.py`` reads the per-layer metrics
  ``<family>`` and ``<family>.<cell part>``; a per-layer entry lists the
  cells that report it under ``workloads``.

A run: set-up (the kind's ``setup``, timed from process start to the
first timed step as ``setup_s``), then whole steps until their summed
time reaches ``--seconds`` (inputs are made between steps, outside the
timing), the peak device memory, with ``--trace 1`` a few more steps
under the profiler, then the program's state is dropped and what it
produced is judged against the float64 reference.

A cell's ``chips`` are its devices: the first ``chips`` CUDA cards
(``cuda:0`` ...), or as many CPU devices on the CPU, as
``make_mesh(n, device="cpu")`` takes them.  The kind's runner gets them
all; the result reads each card apart: the peak memory is the fullest
card's, ``busy_s`` the mean over the cards, each with its per-card list
beside it, and every card's cache is emptied before the judgement.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import time

import torch

from . import devtrace

FORBIDDEN = ("jax", "jaxlib", "flax", "gpyreg_tpu")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the benchmark must never
    load, compared whole (``gpyreg_tpu_torch`` is not ``gpyreg_tpu``)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def _json(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


class Cell:
    """One ``workloads`` entry with everything found by its names."""

    def __init__(self, root, name):
        manifest = _json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.cfg = _json(root, configs[self.entry["config"]]["file"])
        self.traffic = _json(
            root, f"portbench/traffic/{self.entry['traffic']}.json")
        self.limits = _json(root, f"portbench/limits/{name}.json")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m["workloads"]]

    def kind(self):
        return importlib.import_module(
            f"portbench.kinds.{self.traffic['kind']}")

    @staticmethod
    def reader(metric):
        """The ``read`` function of a per-layer metric's family file."""
        return importlib.import_module(
            f"portbench.layer_metrics.{metric.split('.')[0]}").read


def cell_devices(platform, chips):
    """The devices of a cell of ``chips`` on ``platform`` ("cuda" or
    "cpu")."""
    if platform == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [torch.device(platform)] * chips


class Context:
    """What a per-layer reader gets: the cell, the unprofiled window's
    step records and seconds, the profiled steps with their trace, how
    many launches of each hand-written kernel the port's own counter
    (``ops.tile_kernels.LAUNCHES``) saw during the profiled steps.  The
    cell's cards are the trace's devices 0 to ``cell.chips`` - 1."""

    def __init__(self, cell, records, window_s, traced, trace, launches):
        self.cell = cell
        self.records = records
        self.window_s = window_s
        self.traced = traced
        self.trace = trace
        self.launches = launches


def _timed_steps(runner, seconds, span=False):
    """Whole steps until their summed time reaches ``seconds`` (at least
    one); returns the step records, each with its ``wall`` seconds."""
    records, total = [], 0.0
    while not records or total < seconds:
        runner.prepare()
        t0 = time.perf_counter()
        if span:
            with torch.profiler.record_function(devtrace.STEP_SPAN):
                rec = runner.step()
        else:
            rec = runner.step()
        wall = time.perf_counter() - t0
        rec["wall"] = wall
        records.append(rec)
        total += wall
        runner.after(rec)
    return records, total


def _judge(runner, control):
    """Readings of the program's outputs (and, with ``control``, of the
    reference's own in TF32 put in the program's place) against the
    float64 reference."""
    from portbench.reference.gp import F64, TF32

    ref = runner.reference_outputs(F64)
    readings = runner.compare(runner.judged_outputs(), ref)
    ctl = None
    if control:
        ctl = runner.compare(runner.reference_outputs(TF32), ref)
    return readings, ctl


def _checks(readings, limits):
    """{name: {"value", "limit"}} and whether every value is finite and
    within its limit."""
    checks, ok = {}, True
    for name, value in readings.items():
        limit = limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"limits without readings: {sorted(missing)}")
    return checks, ok


def empty_caches(devices):
    """Release the cached blocks of every CUDA card of ``devices``, so
    that the float64 reference finds each card's memory free."""
    for d in devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


def _device(cell, devices, peaks, tr):
    """The result's ``device``: the fullest card's peak memory, and with
    a trace ``busy_s``, the mean over the cards, and ``window_s``; each
    per-card reading also as a list, in the cards' order."""
    is_cuda = devices[0].type == "cuda"
    dev = {
        "platform": "gpu" if is_cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if is_cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(max(peaks)),
        "memory_peak_bytes_per_device": [int(p) for p in peaks],
    }
    if is_cuda:
        dev["power_limit"] = _power_limit()
    if tr is not None:
        busy = [tr.busy_us(i) / 1e6 for i in range(cell.chips)]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["busy_s_per_device"] = busy
        dev["window_s"] = tr.window_us() / 1e6
    return dev


def run_cell(root, workload, seed, seconds, trace, platform, t0,
             control=False, cell=None):
    """Run ``workload`` once on ``platform`` ("cuda" or "cpu"), on the
    cell's devices (:func:`cell_devices`); returns (result, checks,
    control).  With ``control``, the control's readings go through the
    same limits: ``control`` is {"checks", "correct"}, and None without.
    ``cell`` replaces the files' cell (the tests give a small one)."""
    from gpyreg_tpu_torch.ops import tile_kernels

    cell = cell or Cell(root, workload)
    devices = cell_devices(platform, cell.chips)
    runner = cell.kind().Runner(cell.cfg, cell.traffic, seed, devices)
    is_cuda = platform == "cuda"
    runner.setup()
    devtrace_on = bool(trace)
    # Set-up ends where the first timed step starts.
    setup_s = time.perf_counter() - t0
    records, window_s = _timed_steps(runner, seconds)
    peaks = [torch.cuda.max_memory_allocated(d) if is_cuda else 0
             for d in devices]
    traced = tr = None
    if devtrace_on:
        steps = int(cell.traffic["trace_steps"])
        holder = {}

        def run():
            holder["records"] = [
                _timed_steps(runner, 0.0, span=True)[0][0]
                for _ in range(steps)
            ]

        before = dict(tile_kernels.LAUNCHES)
        tr = devtrace.capture(run, platform)
        launches = {k: tile_kernels.LAUNCHES[k] - before[k] for k in before}
        traced = holder["records"]
    if forbidden_modules():
        raise RuntimeError(f"loaded {forbidden_modules()}")
    all_records = records + (traced or [])
    attempted = len(all_records)
    failed = sum(0 if r["finite"] else 1 for r in all_records)

    metrics = {}
    if devtrace_on:
        ctx = Context(cell, records, window_s, traced, tr, launches)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = runner.end_to_end(records, window_s)
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    runner.release()
    empty_caches(devices)
    readings, ctl = _judge(runner, control)
    checks, ok = _checks(readings, cell.limits)
    if ctl is not None:
        ctl_checks, ctl_ok = _checks(ctl, cell.limits)
        ctl = {"checks": ctl_checks, "correct": bool(ctl_ok)}
    result = {
        "correct": bool(ok and failed == 0),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": _device(cell, devices, peaks, tr),
    }
    if devtrace_on:
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result, checks, ctl


def main(argv, t0, root):
    import argparse

    p = argparse.ArgumentParser(
        description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell(root, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks, _ = run_cell(root, args.workload, args.seed, args.seconds,
                                 args.trace, "cuda", t0, cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
