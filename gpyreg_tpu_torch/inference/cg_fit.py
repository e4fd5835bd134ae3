"""The matrix-free (CG/BBMM) fit path of ``GP.fit(options={"method":
"cg"})``.

Port of ``gpyreg_tpu/inference/cg_fit.py`` (``fit_cg_path``, :35-318).
Past the Cholesky N limit the kernel matrix is never materialized: a
small Sobol design is ranked by the CG+SLQ objective at CG tolerance
1e-3, the best row starts scipy's L-BFGS-B over the stochastic NLML
(``ops.iterative.fit_cg``, common random numbers), and the GP stores
matrix-free posteriors whose CG weight vector is solved at the first
predict.  A hyperposterior chain runs only when the caller gives
``n_samples`` (else a warning): a slice chain on the fixed-probe
surrogate posterior (``ops.iterative.cg_log_post_raw``, one frozen probe
seed for the whole chain), driven by ``inference.device_slice.sample``
below ``_CG_SAMPLE_HOST_MIN_N`` rows and by the host ``SliceSampler`` at
or above it (``cg_sample_driver`` forces either).  From
``_CG_SAMPLE_SEG_MIN_N`` rows up the shrink loop stops after 48 steps,
not 256 (``cg_sample_max_shrink``), which changes the proposals a chain
takes, as in JAX.

Left out, being TPU-only: the dispatch segmentation, ``seg_moves`` of the
device chain (:190-216), which bounds a dispatch under the TPU runtime's
watchdog (the port's chain is driven from the host one density at a
time); ``_jit_by_identity`` (:239); the compile log (:302-317).
``GP.fit``'s ``trace_dir`` profiles this path too, with its phases as
``tracing.phase`` spans.
"""

import warnings

import numpy as np
import torch

from ..f_min_fill import build_design
from ..ops import iterative as _iterative
from ..slice_sample import SliceSampler
from ..tracing import phase
from . import device_slice as _device_slice
from .sampling import sample_log_priors

# The JAX package's sampling thresholds (gpyreg_tpu/gp.py:215, :228): from
# 2,048 rows the chain's shrink loop is capped at 48 steps; from 32,768
# rows the host sampler drives the chain.
_CG_SAMPLE_SEG_MIN_N = 2048
_CG_SAMPLE_HOST_MIN_N = 32768


def fit_cg_path(gp, hyp0, LB, UB, PLB, PUB, options, tol_opt, s_N):
    """Matrix-free MAP fit, and the fixed-probe chain on explicit request,
    called from ``GP.fit`` after the data and bounds are set.  Returns
    (hyp, optimize result, sampling result or None).  Objective
    evaluations whose CG stopped at ``cg_max_iter`` are not hidden: the
    fit warns (``res.cg_iters`` holds every evaluation's iterations)."""
    sample_requested = s_N > 0 and "n_samples" in options
    if s_N > 0 and not sample_requested:
        warnings.warn(
            'fit(options={"method": "cg"}) samples only on '
            f"explicit request: skipping the default n_samples="
            f"{s_N} hyperposterior sampling (pass n_samples in "
            "options to run the fixed-probe chain, or 0 to "
            "acknowledge MAP-only).",
            stacklevel=3,
        )
    cg_opts = {
        "row_chunk": int(options.get("cg_row_chunk", 1024)),
        "max_iter": int(options.get("cg_max_iter", 500)),
    }
    fit_opts = dict(
        cg_tol=float(options.get("cg_tol", 1e-5)),
        n_probes=int(options.get("cg_n_probes", 8)),
        n_lanczos=int(options.get("cg_n_lanczos", 32)),
        max_opt_iter=int(options.get("cg_max_opt_iter", 100)),
        warm_start=bool(options.get("cg_warm_start", True)),
        **cg_opts,
    )
    spec = gp._spec()
    hyp0_2d = np.atleast_2d(np.asarray(hyp0, dtype=np.float64))
    init_N = int(options.get("cg_init_N", 16))
    key = int(options.get("cg_seed", 0))
    hyp0 = hyp0_2d[0]
    timings = gp.fit_timings
    with phase(timings, "design_s"):
        X, y, s2 = gp._data()
        # A small Sobol design ranked by a loose-tolerance CG objective:
        # the mid-plausible start often sits on a plateau where L-BFGS-B
        # stalls.
        if init_N > 1:
            gp.hyper_priors["df"][
                np.isnan(gp.hyper_priors["df"])
            ] = options.get("df_base", 7)
            design = build_design(
                hyp0_2d, LB, UB, PLB, PUB, gp.hyper_priors, init_N,
                options.get("init_method", "sobol"),
            )
            vals = np.array([
                _iterative.cg_nlml(
                    spec, h, X, y, s2, key=key, tol=1e-3,
                    row_chunk=cg_opts["row_chunk"],
                    max_iter=cg_opts["max_iter"],
                    n_probes=fit_opts["n_probes"],
                    n_lanczos=fit_opts["n_lanczos"],
                )
                for h in design
            ])
            finite = np.isfinite(vals)
            if np.any(finite):
                hyp0 = design[np.argmin(np.where(finite, vals, np.inf))]

    with phase(timings, "optimize_s"):
        hyp_opt, res = _iterative.fit_cg(
            spec, X, y, s2=s2, hyp0=hyp0, LB=LB, UB=UB, key=key,
            tol=float(options.get("tol_opt", tol_opt)), **fit_opts,
        )
    iters = getattr(res, "cg_iters", None)
    if iters is not None and np.any(iters >= cg_opts["max_iter"]):
        warnings.warn(
            f"{int(np.sum(iters >= cg_opts['max_iter']))} of {len(iters)} "
            f"objective evaluations stopped CG at cg_max_iter="
            f"{cg_opts['max_iter']} before cg_tol; CG iterations "
            f"{iters.tolist()}", stacklevel=3)

    # Serving options of the stored matrix-free posteriors.
    gp._infer_method = "cg"
    gp._cg_options = {
        "tol": float(options.get("cg_predict_tol", 1e-6)),
        "test_chunk": int(options.get("cg_test_chunk", 1024)),
        "precond_rank": int(options.get("cg_precond_rank", 0)),
        **cg_opts,
    }

    sampling_result = None
    hyp = np.reshape(hyp_opt, (1, -1))
    with phase(timings, "sample_s"):
        if sample_requested:
            sampling_result, hyp = _fixed_probe_chain(
                gp, spec, hyp_opt, LB, UB, PLB, PUB, options, s_N, key,
                cg_opts, fit_opts, X, y, s2,
            )

    with phase(timings, "posterior_s"):
        gp.update(hyp=hyp)
    return hyp, res, sampling_result


def _fixed_probe_chain(gp, spec, hyp_opt, LB, UB, PLB, PUB, options, s_N, key,
                       cg_opts, fit_opts, X, y, s2):
    """The hyperposterior chain on the frozen-probe surrogate
    (``gpyreg_tpu/inference/cg_fit.py:154-296``).  Its CG budget is
    tunable apart from the fit's (``cg_sample_tol``,
    ``cg_sample_max_iter``): the frozen probes make the surrogate a
    deterministic function of the hyperparameters at any tolerance.
    Returns (sampling result, kept samples)."""
    thin = int(options.get("thin", 5))
    burn = int(options.get("burn", thin * s_N))
    _, _, _, pack = gp._device()
    log_f, _ = _iterative.cg_log_post_raw(
        spec,
        float(options.get("cg_sample_tol", fit_opts["cg_tol"])),
        cg_opts["row_chunk"],
        int(options.get("cg_sample_max_iter", cg_opts["max_iter"])),
        fit_opts["n_probes"],
        fit_opts["n_lanczos"],
        s2 is not None,
        pack is not None,
    )
    f_args = [X, y]
    if s2 is not None:
        f_args.append(s2)
    if pack is not None:
        f_args.append(pack)
    f_args.append(key)  # the frozen probe seed of the design and the MAP
    f_args = tuple(f_args)
    mc_seed = int(np.random.randint(0, 2**31 - 1))
    N = X.shape[0]
    # A dimension whose plausible bounds clamp together must not abort
    # the chain after the MAP phase.
    widths = np.asarray(PUB - PLB, dtype=np.float64)
    idx0 = widths == 0
    if np.any(idx0):
        widths[idx0] = np.minimum(1.0, (UB - LB)[idx0])
    width_base = options.get("sample_width_base", True)
    driver = str(options.get("cg_sample_driver", "auto"))
    use_host = driver == "host" or (
        driver == "auto" and N >= _CG_SAMPLE_HOST_MIN_N)
    x0 = np.ravel(np.asarray(hyp_opt, dtype=np.float64))
    if use_host:
        def host_log_f(h):
            return float(log_f(torch.as_tensor(h, dtype=torch.float64),
                               *f_args))

        slicer = SliceSampler(
            host_log_f, x0, widths, LB, UB,
            {
                "display": options.get("display", "off"),
                "diagnostics": options.get("sampler_diagnostics", True),
                "width_base": width_base,
            },
        )
        sampling_result = slicer.sample(s_N * thin, thin=1, burn=burn)
        sampling_result["n_evals"] = slicer.func_count
    else:
        max_shrink = 48 if N >= _CG_SAMPLE_SEG_MIN_N else 256
        sampling_result, _ = _device_slice.sample(
            log_f, x0, mc_seed, widths=widths, LB=LB, UB=UB,
            n_samples=s_N * thin, thin=1, burn=burn,
            max_shrink=int(options.get("cg_sample_max_shrink", max_shrink)),
            f_args=f_args, width_base=width_base,
        )
    samples = np.asarray(sampling_result["samples"])
    hyp = samples[thin - 1 :: thin][:s_N]
    f_vals = np.asarray(sampling_result["f_vals"]).ravel()[thin - 1 :: thin][:s_N]
    # The chain's values are log posteriors; the prior does not depend on
    # the kernel, so the exact path's bundle gives it.
    fns_e, obj_args_e = gp._obj_args()
    log_priors = sample_log_priors(gp, hyp, fns_e, obj_args_e)
    sampling_result["samples"] = hyp
    sampling_result["f_vals"] = (f_vals - log_priors).reshape(-1, 1)
    sampling_result["log_priors"] = log_priors
    return sampling_result, hyp
