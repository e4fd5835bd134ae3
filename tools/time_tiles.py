#!/usr/bin/env python3
"""Time the port's two tile kernels through their wrappers, at the shapes
the main paths give them, with sf2 and alpha passed as device tensors (as
the main paths pass them) and as Python floats.

Run from the root of a checkout, on a machine with a card:

    python3 tools/time_tiles.py [--root DIR]

``--root`` names the checkout whose ``gpyreg_tpu_torch`` is timed (this
one by default), so that two trees can be compared on one card within one
call: run it for each in turns, A, B, B, A.  The kernels are built at
first use into that checkout.

Shapes: the kernel tile (``ops.tile_kernels.kernel_cross``, profile se)
at the 16384 x 16384 self-covariance and the 16384 x 16384 and
16384 x 1696 cross-covariances of config 5 (D = 10), and at the
4096 x 4096 self-covariance of bench.py's workload (D = 8); the gradient
tile (``vjp_tile``, se ARD) at N = 16384, D = 10 and N = 4096, D = 8, with
a random cotangent.  Inputs come from seed 0.  Each time is CUDA events
around back-to-back calls after one warm-up call, divided by the count.

Prints the card's name and power limit, then one JSON line.  Imports
nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time_ms(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=ROOT,
                        help="checkout whose gpyreg_tpu_torch is timed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_tiles.py needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}; timing {os.path.dirname(TK.__file__)}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def mat(n, d):
        return torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                               device=dev)

    sf2 = torch.tensor(float(np.exp(0.2)), dtype=torch.float32, device=dev)
    alpha = torch.tensor(float(np.exp(0.3)), dtype=torch.float32, device=dev)
    floats = (sf2.item(), alpha.item())
    X16, Z16, X4 = mat(16384, 10), mat(16384, 10), mat(4096, 8)
    Z16t = Z16[:1696].contiguous()
    cases = [
        ("kernel_tile self 16384x16384 D=10", 10,
         lambda a, b: TK.kernel_cross("se", X16, X16, a, b, zero_diag=True)),
        ("kernel_tile cross 16384x16384 D=10", 10,
         lambda a, b: TK.kernel_cross("se", X16, Z16, a, b)),
        ("kernel_tile cross 16384x1696 D=10", 40,
         lambda a, b: TK.kernel_cross("se", X16, Z16t, a, b)),
        ("kernel_tile self 4096x4096 D=8", 100,
         lambda a, b: TK.kernel_cross("se", X4, X4, a, b, zero_diag=True)),
    ]
    out = {}
    for name, reps, fn in cases:
        out[name] = {"device_ms": _time_ms(lambda: fn(sf2, alpha), reps),
                     "float_ms": _time_ms(lambda: fn(*floats), reps)}
    for n, d, reps in ((16384, 10, 10), (4096, 8, 100)):
        X = X16 if n == 16384 else X4
        G = torch.as_tensor(rng.normal(size=(n, n)), dtype=torch.float32,
                            device=dev)
        name = f"kernel_vjp se N={n} D={d}"
        out[name] = {
            "device_ms": _time_ms(
                lambda: TK.vjp_tile("se", False, X, G, sf2, alpha), reps),
            "float_ms": _time_ms(
                lambda: TK.vjp_tile("se", False, X, G, *floats), reps),
        }
        del G
    for name, r in out.items():
        print(f"{name}: device params {r['device_ms']:.4f} ms, Python floats "
              f"{r['float_ms']:.4f} ms")
    print(json.dumps({"card": smi, "root": root, "times": out}))


if __name__ == "__main__":
    main()
