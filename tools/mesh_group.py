#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mesh group (phase 26) on its own, with only the
phases it compares with: the single-device ``fit_bench`` fit (phase 12)
and the CG tier's MAP (phase 23's, passed in, not refitted).

Run from the root of a checkout, on a machine with one card or several:

    python3 tools/mesh_group.py

The mesh is the smoke's: the first 2 or 4 cards of a host that has two
or more, else 4 shards of the one card.  On a host with several cards
this times the sharded paths across cards (the phases' own lines: the
dist_exact build + factor and solves, the sharded predict against the
single device, the sharded CG's seconds and ms a matvec), which the
smoke on a one-card host cannot.  Phase 23's single-device matvec time
is not measured here (printed as nan).  Prints the card's name and power
limit, each phase's line, and the group's seconds.  Imports nothing of
JAX.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# Phase 23's MAP (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py run in
# which its fit took 21 evaluations): the 65,536-row CG solve's
# hyperparameters.
CG_MAP = np.array([0.9257197657482928, 0.9013161215579418, 0.9100570863748546,
                   0.9049989502867146, 0.02763597869133394, -1.4552378260657834,
                   -0.05445917501985156])


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/mesh_group.py needs a CUDA device")
    t0 = time.perf_counter()
    cs.phase_device()
    cs.phase_build()
    mesh = cs._smoke_mesh()
    X_tr, y_tr, hyps_tr = cs._train_data(cs.N_TR, cs.SEED)
    windows = cs._count_chain_windows()
    cs.phase_fit_warm()
    fit_b = cs.phase_fit("fit_bench", *cs.FIT_BENCH, compare_float64=False)
    mv = cs._count_matvecs()
    cs.phase_mesh(mesh, cs._de_data(), float("nan"), X_tr, y_tr, hyps_tr,
                  fit_b, {"hyp": CG_MAP, "mv_ms": float("nan")},
                  cs._cg_data(), mv, windows)
    print(f"wall: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
