"""The design + multistart-MAP phase of ``GP.fit``.

Port of ``gpyreg_tpu/inference/fit_phases.py`` (reference flow
gaussian_process.py:1087-1196), with its three backends:

- fused device path (default): design construction on the host, then
  design ranking + start selection + multistart L-BFGS in
  ``map_optimize.design_optimize``;
- split device path (``opts_N == 0``): ``f_min_fill`` with the GP's
  batched objective, and no optimization;
- scipy path (``optimizer_backend='scipy'``): sequential L-BFGS-B
  restarts driving the GP's value-and-gradient, matching the reference's
  optimizer exactly (gaussian_process.py:1177-1188).

Left out, with the JAX package's lines: ``_design_chunk`` (:29-42), which
bounds the ``(chunk, N, N)`` workspace of a vmapped ranking program; the
design rows run one at a time here, so one row's (N, N) buffers are live
at once and there is nothing to bound; the segment plan (:198-204), which
``map_optimize`` leaves out; and the
``multistart_map`` branch after the split design (:264-278), which no
combination of options reaches (the device backend with ``opts_N > 0`` is
the fused path).  The sorted design and its values come back as host
arrays.  ``gp.mesh`` goes to ``design_optimize`` (:223), which shards the
design rows and the restart lanes over it.
"""

import math
import time

import numpy as np
import scipy as sp

from ..core.nlml import get_fns
from ..f_min_fill import build_design, f_min_fill
from . import map_optimize as _map_optimize


def design_and_map(
    gp,
    hyp0,
    LB,
    UB,
    PLB,
    PUB,
    options,
    opts_N,
    init_N,
    init_method,
    tol,
    cov_N,
    noise_N,
    t_start,
):
    """Run the space-filling design and multistart MAP optimization.

    Sets ``gp.fit_timings['design_s'/'optimize_s']`` and returns
    ``(hyp, nll, opt_results, opts_N, widths_default, X0, y0)``: the
    optimized starts (rows), their objective values, per-restart
    optimizer results, the possibly-reduced restart count, the slice
    widths derived from the design spread (zero-fixed), and the sorted
    design with its values when the fused path ran (the candidate pool
    for a sampler's non-finite-start fallback), else None.

    ``design_s`` covers building the design and ranking it on the
    device, ``optimize_s`` the restarts.  (The JAX package's fused program
    cannot tell its ranking from its restarts and counts both as
    ``optimize_s``.)
    """
    objective_f_1 = lambda hyp_: gp._objective(hyp_)

    opt_backend = options.get("optimizer_backend", "device")
    fused_device = opt_backend == "device" and opts_N > 0
    X0_s = y0_s = None

    ## Space-filling design (evaluated on the device).
    if fused_device:
        hyp0_2d = np.atleast_2d(np.asarray(hyp0, dtype=np.float64))
        if init_N > 0:
            design = build_design(
                hyp0_2d,
                LB,
                UB,
                PLB,
                PUB,
                gp.hyper_priors,
                init_N,
                init_method,
            )
        else:
            design = hyp0_2d
        gp.fit_timings["design_s"] = time.perf_counter() - t_start
    elif init_N > 0:
        X0, y0 = f_min_fill(
            objective_f_1,
            hyp0,
            LB,
            UB,
            PLB,
            PUB,
            gp.hyper_priors,
            init_N,
            init_method,
            f_batch=gp._objective_batch,
        )
        hyp = X0[0 : np.maximum(opts_N, 1), :]

        # A good low-noise candidate for the second restart
        # (reference gaussian_process.py:1112-1125).
        if noise_N > 0 and 1 < opts_N < init_N:
            xx = X0[opts_N:, :]
            noise_y = y0[opts_N:]
            noise_params = xx[:, cov_N]
            order = np.argsort(noise_params)
            xx = xx[order, :]
            noise_y = noise_y[order]
            idx_best = np.argmin(
                noise_y[0 : math.ceil(0.2 * np.size(noise_y))]
            )
            hyp[1, :] = xx[idx_best, :]

        if init_N > 1:
            widths_default = np.std(X0, axis=0, ddof=1)
        else:
            widths_default = np.zeros(shape=PLB.shape)
    else:
        nll = gp._objective_batch(hyp0)
        order = np.argsort(nll)
        hyp = hyp0[order, :]
        widths_default = PUB - PLB

    if not fused_device:
        gp.fit_timings["design_s"] = time.perf_counter() - t_start

    ## Multistart MAP optimization.
    if fused_device:
        fns, obj_args = gp._obj_args()
        k = int(min(opts_N, design.shape[0]))
        low_idx = (
            cov_N if (noise_N > 0 and 1 < opts_N < init_N) else None
        )
        # Optional subset RANKING of the design (off by default): each
        # candidate's NLML costs O(N^3), so at large N the ranking
        # dominates the design+MAP phase even though it only picks the
        # multistart STARTING points.  options["design_subset"]=n_sub
        # ranks the candidates on an evenly-strided n_sub-row data subset
        # (deterministic, no RNG stream change) at O((n_sub/N)^3) of the
        # cost; the multistart L-BFGS and every reported objective value
        # still use the full data.  The reference ranks on the full data
        # (f_min_fill.py:175): an opt-in deviation in start-selection
        # fidelity only.
        design_f_args = None
        n_sub = int(options.get("design_subset", 0) or 0)
        n_true = int(gp.X.shape[0])
        if init_N > 0 and 0 < n_sub < n_true:
            spec_d, _, _, pack_d = gp._device()
            idx_sub = np.round(
                np.linspace(0, n_true - 1, n_sub)
            ).astype(int)
            fns_sub = get_fns(spec_d, gp.s2 is not None, pack_d is not None)
            sub = [gp._tensor(gp.X[idx_sub]), gp._tensor(gp.y[idx_sub])]
            if gp.s2 is not None:
                sub.append(gp._tensor(gp.s2[idx_sub]))
            if pack_d is not None:
                sub.append(pack_d)
            design_f_args = tuple(sub)
            obj_design_fn = fns_sub["obj_design_raw"]
        else:
            obj_design_fn = fns["obj_design_raw"]
        (
            xs,
            fs,
            opt_results,
            w_prog,
            X0_s,
            y0_s,
        ) = _map_optimize.design_optimize(
            fns["obj_raw"],
            design,
            LB,
            UB,
            f_args=obj_args,
            tol=tol,
            opts_N=k,
            low_noise_idx=low_idx,
            obj_design_raw=obj_design_fn,
            design_f_args=design_f_args,
            device=gp.device,
            timings=gp.fit_timings,
            mesh=gp.mesh,
        )
        gp.fit_timings["design_s"] += gp.fit_timings.pop("rank_s")
        opts_N = k
        hyp = np.array(xs)
        nll = np.array(fs)
        if init_N > 1:
            widths_default = w_prog.copy()
        elif init_N > 0:
            widths_default = np.zeros(shape=PLB.shape)
        else:
            widths_default = PUB - PLB

    # Fix zero widths.
    idx0 = widths_default == 0
    if np.any(idx0):
        if np.shape(hyp)[0] > 1:
            std_hyp = np.std(hyp, axis=0, ddof=1)
            widths_default[idx0] = std_hyp[idx0]
            idx0 = widths_default == 0
        if np.any(idx0):
            widths_default[idx0] = np.minimum(1, UB[idx0] - LB[idx0])

    if not fused_device:
        # Clamp starts strictly inside finite bounds (the fused path
        # transforms to the unbounded z-space instead).
        eps_LB = np.reshape(LB.copy(), (1, -1))
        eps_UB = np.reshape(UB.copy(), (1, -1))
        LB_idx = (eps_LB != eps_UB) & np.isfinite(eps_LB)
        UB_idx = (eps_LB != eps_UB) & np.isfinite(eps_UB)
        eps_LB[LB_idx] = np.nextafter(eps_LB[LB_idx], np.inf)
        eps_UB[UB_idx] = np.nextafter(eps_UB[UB_idx], -np.inf)
        hyp = np.minimum(eps_UB, np.maximum(eps_LB, hyp))

        nll = np.full((np.maximum(opts_N, 1),), np.inf)
        opt_results = []
        opts_N = np.minimum(opts_N, hyp.shape[0])

        # Sequential L-BFGS-B restarts (none when opts_N == 0).
        objective_f_2 = lambda hyp_: gp._objective(hyp_, grad=True)
        for i in range(opts_N):
            res = sp.optimize.minimize(
                fun=objective_f_2,
                x0=hyp[i, :],
                jac=True,
                bounds=list(zip(LB, UB)),
                tol=tol,
            )
            opt_results.append(res)
            hyp[i, :] = res.x
            nll[i] = res.fun

    gp.fit_timings["optimize_s"] = (
        time.perf_counter() - t_start - gp.fit_timings["design_s"]
    )

    return hyp, nll, opt_results, opts_N, widths_default, X0_s, y0_s
