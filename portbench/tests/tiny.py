"""Small cells of the benchmark for tests on the CPU: the manifest's
cells with their sizes cut, so that the harness runs everything a run
does (set-up, window, judgement) in a second.

The cells are every ``workloads`` entry of the root's ``BENCHMARK.json``.
A configuration's small sizes are in ``portbench/small/<config>.json``:
``sizes`` for a run, ``control`` for the TF32 control's run, each merged
over the configuration's file."""

import json
import os
import time

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRAFFIC = {"points_per_request": 400, "judged_points": 200, "trace_steps": 3}


def manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = tuple(w["name"] for w in manifest()["workloads"])


def small(config, root=ROOT):
    """The small sizes of ``config``: {"sizes", "control"}."""
    with open(os.path.join(root, "portbench", "small", f"{config}.json")) as f:
        return json.load(f)


def cell(name, root=ROOT, sizes="sizes"):
    """The cell ``name`` at its configuration's small ``sizes`` ("sizes"
    or "control")."""
    c = harness.Cell(root, name)
    c.cfg = {**c.cfg, **small(c.entry["config"], root)[sizes]}
    c.traffic = {k: TRAFFIC.get(k, v) for k, v in c.traffic.items()}
    return c


def run(name, seed=2**31 + 5, trace=0, control=False, root=ROOT, c=None):
    c = c or cell(name, root)
    return harness.run_cell(root, name, seed, 0.2, trace, "cpu",
                            time.perf_counter(), control=control, cell=c)
