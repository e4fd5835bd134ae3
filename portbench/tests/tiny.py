"""Small cells of the benchmark for tests on the CPU: the files' cells
with their sizes cut, so that the harness runs everything a run does
(set-up, window, judgement) in a second."""

import os
import time

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ("config5.predict", "d8.nlml_grad", "config5.posterior")
SIZES = {"config5": {"N": 96, "D": 3, "S": 4}, "d8": {"N": 80, "D": 3, "B": 4}}
TRAFFIC = {"points_per_request": 400, "judged_points": 200, "trace_steps": 3}


def cell(name, root=ROOT, sizes=None):
    c = harness.Cell(root, name)
    c.cfg = {**c.cfg, **(sizes or SIZES[c.entry["config"]])}
    c.traffic = {k: TRAFFIC.get(k, v) for k, v in c.traffic.items()}
    return c


def run(name, seed=2**31 + 5, trace=0, control=False, root=ROOT, c=None):
    c = c or cell(name, root)
    return harness.run_cell(root, name, seed, 0.2, trace, "cpu",
                            time.perf_counter(), control=control, cell=c)
