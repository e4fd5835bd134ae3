#!/usr/bin/env python3
"""Profile the PyTorch port's serving slice on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/profile_torch_slice.py [--trace PATH]

It builds the config-5 GP of ``chip_smoke.py`` (N = 16384, D = 10, 8
hyperparameter samples, float32, 100,000 test points, data from seed 0)
and then:

1. warms up with one ``update`` and one ``predict``;
2. runs one ``update`` and one ``predict`` under ``torch.profiler``
   (CPU and CUDA activities), each inside a ``record_function`` span that
   ends with a synchronize, and exports the Chrome trace to ``--trace``.
   From the trace's events it reports, for each span: its wall time; the
   device busy time, the union of the intervals of the ``kernel``,
   ``gpu_memcpy`` and ``gpu_memset`` events inside the span (device
   events only, so an operator and the kernels under it are never
   counted twice); the device idle share, 1 - busy / wall; and the device
   time of each kernel name (the largest 12), as a share of the wall;
3. sweeps the test-point chunk of ``predict`` through 4096, 8192, 16384,
   8192, 4096 and 16384 points, in that order so that drift shows, and
   reports points/s for each.

Prints the card's name and power limit first and one JSON object of all
results last.  Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SWEEP = (4096, 8192, 16384, 8192, 4096, 16384)


def _union_us(intervals):
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def _spans(trace_path, names):
    """Per span name: wall ms, device busy ms, idle share and the device
    ms of the largest kernel names, from the Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = {
        e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") in names
    }
    if set(spans) != set(names):
        raise RuntimeError(f"trace has spans {sorted(spans)}, not {names}")
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    out = {}
    for name, (t0, t1) in spans.items():
        inside = [
            e for e in device
            if float(e["ts"]) >= t0 and float(e["ts"]) + float(e["dur"]) <= t1
        ]
        busy = _union_us(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in inside
        )
        by_name = {}
        for e in inside:
            key = e["name"][:100]
            by_name[key] = by_name.get(key, 0.0) + float(e["dur"])
        wall = t1 - t0
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        out[name] = {
            "wall_ms": wall / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall,
            "device_events": len(inside),
            "top_kernels": [
                {"name": k, "ms": v / 1e3, "share_of_wall": v / wall}
                for k, v in top
            ],
        }
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--trace",
        default=os.path.join(ROOT, "gpyreg_tpu_torch", "build",
                             "profile_torch_slice.json"),
        help="where to write the Chrome trace",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice.py needs a CUDA device")
    sys.path.insert(0, ROOT)
    import numpy as np

    import gpyreg_tpu_torch as gt
    from gpyreg_tpu_torch import gp as gp_mod
    from chip_smoke import D, M_TEST, N, SEED, _data

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    X, y, xs, hyp = _data(N, M_TEST, SEED)
    gp = gt.GP(
        D,
        gt.covariance_functions.SquaredExponential(),
        gt.mean_functions.ConstantMean(),
        gt.noise_functions.GaussianNoise(constant_add=True),
        dtype=np.float32,
        device="cuda",
    )
    gp.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=True)
    gp.predict(xs)
    torch.cuda.synchronize()

    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    host = {}
    with torch.profiler.profile(activities=acts) as prof:
        for name, fn in (
            ("update", lambda: gp.update(hyp=hyp, compute_posterior=True)),
            ("predict", lambda: gp.predict(xs)),
        ):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                fn()
                torch.cuda.synchronize()
            host[name] = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(args.trace)
    spans = _spans(args.trace, ("update", "predict"))
    for name, r in spans.items():
        r["host_wall_ms"] = host[name]
        print(f"{name}: wall {r['wall_ms']:.1f} ms (host clock "
              f"{host[name]:.1f} ms), device busy {r['device_busy_ms']:.1f} "
              f"ms, idle share {r['device_idle_share']:.4f}")
        for k in r["top_kernels"]:
            print(f"  {k['ms']:10.2f} ms {100 * k['share_of_wall']:6.2f}%  "
                  f"{k['name']}")

    sweep = []
    default = gp_mod._PREDICT_CHUNK_ELEMS
    try:
        for chunk in SWEEP:
            gp_mod._PREDICT_CHUNK_ELEMS = chunk * N
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gp.predict(xs)
            secs = time.perf_counter() - t0
            sweep.append({"chunk": chunk, "pts_per_s": M_TEST / secs})
            print(f"chunk {chunk}: {M_TEST / secs:.1f} pts/s", flush=True)
    finally:
        gp_mod._PREDICT_CHUNK_ELEMS = default
    print(json.dumps({"card": smi, "spans": spans, "chunk_sweep": sweep}))


if __name__ == "__main__":
    main()
