#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <s> [--out PATH]

For every seed it runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the judgement) and keeps the numbers compared, and the
end-to-end metrics; for each control seed it also puts the reference in
the program's place, computed in TF32 (float32 with TF32 products),
keeps the same numbers of that control and the harness's verdict on
them by the committed limits (``control_correct``, false where the
control fails a limit).  A limit lies above the largest reading of the
program and below the smallest of the control.  Prints one JSON object,
and writes it to ``--out`` when given.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import argparse

    if os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = ROOT
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    args = p.parse_args()
    chips = harness.Cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate.py needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
           "power_limit": harness._power_limit(), "runs": []}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        result, checks, ctl = harness.run_cell(
            ROOT, args.workload, seed, args.seconds, 0, "cuda", t0,
            control=seed in controls)
        out["runs"].append({
            "seed": seed, "program": seed in seeds, "correct": result["correct"],
            "readings": {k: v["value"] for k, v in checks.items()},
            "control": ctl and {k: v["value"] for k, v in ctl["checks"].items()},
            # The harness's verdict on the control, by the committed limits.
            "control_correct": ctl and ctl["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "attempted": result["attempted"],
        })
        print(json.dumps(out["runs"][-1]), file=sys.stderr, flush=True)
        harness.empty_caches(harness.cell_devices("cuda", chips))
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
