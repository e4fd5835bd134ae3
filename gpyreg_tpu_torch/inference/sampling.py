"""The hyperposterior sampling phase of ``GP.fit`` and the slicelite
warm refit.

Port of ``gpyreg_tpu/inference/sampling.py``: ``release_posterior_factors``
(:39-53), ``sample_log_priors`` (:124-137, one ``log_prior_raw`` a
sample), ``store_warm_state`` (:140-157), ``slicelite_ess`` (:160-217),
``slicelite_warm_refit`` (:220-312), ``run_sampling`` (:315-525) for the
samplers "slicesample", "covsample" and "slicelite" on the device and
host backends and the gradient samplers "mala" and "hmc" and the
ensemble sampler "eissample" (:356-365, :396-477; ``mala.py``, ``hmc.py``,
``ensemble_slice.py``), and ``_run_chain_parallel`` (:528-681) with the
cross-chain split R-hat and its exit flags.  Every function takes the GP
first: these are ``fit``'s phases, not standalone API.  Reference
semantics: gaussian_process.py:1232-1305 (sampling phase),
slice_sample.py:632-639 (exit flags); MATLAB oracle gplite_train.m:
178-197, 318-447.

Where the JAX package draws a random key from
``np.random.randint(0, 2**31 - 1)`` (:245, :489-491, :538), the port
draws the same integer from numpy's global stream, in the same order, and
seeds its chain's stream with it (``device_slice.make_stream``), so
numpy's state after a fit is the same in both packages.  The slice and
ensemble chains' density is ``log_post_chain_raw``, one call a proposal
on the GP's device; MALA and HMC call ``log_post_raw``'s value and
gradient, one call a proposal or leapfrog point.  The chain-parallel
branch and the slicelite refit hand ``gp.mesh`` to
``device_slice.sample_chains`` (:273, :604), which places each chain on
its shard's device.

Left out, with the JAX package's lines:

- ``chain_group_plan`` (:56-121) and ``gp._chain_batch_hbm_estimate``
  (``gpyreg_tpu/gp.py:169-195``): they size vmapped (B, N, N) chain
  batches against TPU HBM.  The port's chains run one after the other,
  as every multi-lane path of the port does (``core/nlml._each_lane``),
  so one chain's buffers are live at a time.  ``options["chain_group"]``
  is accepted and every value gives the same chains.  The collapse of
  equal-divisor groups to groups of 1 (:107-109, a fault the JAX package
  carries) is moot for the same reason;
- ``ensemble_slice._log_prior_batch_fn`` (:132-137): the port evaluates
  one prior a sample;
- ``map_optimize.chain_segment_plan`` of the gradient samplers' branches
  (:417-419, :444-449, :471-476): it sizes the TPU-only segmented chains;
- the compile log of the warm refit (:307-311); ``GP.fit``'s
  ``trace_dir`` profiles the refit as any other fit.

A fault of the JAX package that the port does not copy: its host backend
drops ``sample_width_base`` (:519-524); the port passes it to
``SliceSampler`` as ``width_base``.
"""

import warnings

import numpy as np

from ..slice_sample import SliceSampler, effective_n, gelman_rubin
from ..tracing import phase
from . import device_slice as _device_slice
from . import ensemble_slice as _ensemble_slice
from . import hmc as _hmc
from . import mala as _mala


def _new_stream():
    """A chain stream seeded from numpy's global stream, where the JAX
    package draws its key from the same integer."""
    return _device_slice.make_stream(int(np.random.randint(0, 2**31 - 1)))


def release_posterior_factors(gp):
    """Free the previous fit's device posterior factors (the fields of
    ``clean()``, keeping hyp) before a sampling phase: nothing below
    reads them and ``update(hyp=samples)`` rebuilds them at the end.  At
    N = 16384, float32, eight samples hold 8.6 GB of the device."""
    if gp.posteriors is not None:
        for p in gp.posteriors:
            p.alpha = p.sW = p.L = p.sn2_mult = p.L_chol = None


def sample_log_priors(gp, samples, fns, obj_args):
    """Per-sample log priors, for the sampler branches whose chains
    return log-posterior values (chains, the slicelite refresh): the
    sampling_result contract splits f_vals = log posterior - log prior
    (reference slice_sample.py:281-284).  The samples are rounded to the
    GP's dtype first, as the JAX package's batched prior takes them."""
    if gp.no_prior:
        return np.zeros((samples.shape[0],))
    rounded = np.asarray(samples).astype(gp.dtype).astype(np.float64)
    return np.array([float(fns["log_prior_raw"](s, *obj_args)) for s in rounded])


def store_warm_state(gp, hyp, sampling_result, thin, widths):
    """Record the fit's hyperposterior samples, their log-posterior
    values and the slice widths used, so that a later
    ``fit(sampler='slicelite')`` can evaluate the ESS shortcut (the MATLAB
    driver's LogP input, gplite_train.m:178-186).  Host-side numpy only;
    not persisted by save(): the first refit after a load runs the full
    pipeline."""
    f_vals = np.asarray(sampling_result["f_vals"]).ravel()
    log_priors = np.asarray(sampling_result["log_priors"]).ravel()
    logp = (f_vals + log_priors)[thin - 1 :: thin][: hyp.shape[0]]
    if logp.shape[0] == hyp.shape[0] and np.all(np.isfinite(logp)):
        gp._warm_hyp = np.array(hyp, dtype=np.float64)
        gp._warm_logp = logp
        gp._warm_widths = None if widths is None else np.array(widths)


def slicelite_ess(gp, hyp0, options, thin):
    """Importance-weight effective-sample-size test of the previous
    hyperposterior samples under the new data (gplite_train.m:178-197).
    Returns ``(starts, thin_eff, ess_frac)`` when the shortcut applies,
    else None."""
    hyp_prev = np.atleast_2d(np.asarray(hyp0, dtype=np.float64))
    if hyp_prev.shape[0] < 2:
        return None
    # "log_P" is the reference's spelling for the previous samples' log
    # posteriors (reference gaussian_process.py:997, gplite_train.m
    # LogP); accepted as an alias of hyp0_logp.
    logp_prev = options.get("hyp0_logp", options.get("log_P", None))
    if logp_prev is None:
        warm_hyp = getattr(gp, "_warm_hyp", None)
        if (
            warm_hyp is not None
            and warm_hyp.shape == hyp_prev.shape
            and np.array_equal(warm_hyp, hyp_prev)
        ):
            logp_prev = gp._warm_logp
    if logp_prev is None:
        return None
    logp_prev = np.asarray(logp_prev, dtype=np.float64).ravel()
    if logp_prev.shape[0] != hyp_prev.shape[0]:
        raise ValueError(
            "hyp0_logp must have one log-posterior value per hyp0 row."
        )
    # New log posterior of the old samples (the driver's per-row
    # gp_objfun loop, :181-182).
    nll_new = np.asarray(gp._objective_batch(hyp_prev))
    lnw = -nll_new - logp_prev
    finite = np.isfinite(lnw)
    if not np.any(finite):
        return None
    w = np.where(finite, np.exp(lnw - np.max(lnw[finite])), 0.0)
    w = w / np.sum(w)
    ess_frac = (1.0 / np.sum(w**2)) / hyp_prev.shape[0]
    ess_thresh = options.get("ess_thresh", 0.5)
    # The measured fraction is surfaced even when the shortcut is
    # rejected (the fallback's result has no ess_frac of its own); not in
    # fit_timings, whose values must all be seconds.
    gp.slicelite_ess_frac = float(ess_frac)
    if ess_frac <= ess_thresh:
        return None
    # Refresh budget shrinks as the overlap grows (:192-195).
    thin_eff = max(
        1, round(thin * (1 - (ess_frac - ess_thresh) / (1 - ess_thresh)))
    )
    return hyp_prev, int(thin_eff), float(ess_frac)


def slicelite_warm_refit(gp, warm, s_N, LB, UB, PLB, PUB, widths, options):
    """The ESS-shortcut sampling phase: each previous sample seeds a
    no-adaptation slice chain advanced ``thin_eff`` sweeps
    (gplite_train.m:370-380 slicelite with Nopts==0: Adaptive=false,
    starts = previous samples replicated to Ns rows, Burnin =
    Thin_eff*Ns)."""
    hyp_prev, thin_eff, ess_frac = warm
    widths_w = widths
    if widths_w is None:
        widths_w = getattr(gp, "_warm_widths", None)
    if widths_w is None:
        widths_w = PUB - PLB
    # Recycle the previous samples round-robin onto s_N chains (the
    # driver's repmat, :376-378), clamped inside the current bounds (the
    # float32 noise floor may have moved LB).
    x0s = hyp_prev[np.arange(s_N) % hyp_prev.shape[0]]
    x0s = np.minimum(np.maximum(x0s, LB), UB)
    with phase(gp.fit_timings, "sample_s"):
        fns, obj_args = gp._obj_args()
        stream = _new_stream()
        release_posterior_factors(gp)
        samples, f_vals, n_evals, n_sweeps = _device_slice.sample_chains(
            fns["log_post_chain_raw"],
            x0s,
            stream,
            widths=widths_w,
            LB=LB,
            UB=UB,
            n_samples=1,
            thin=1,
            burn=thin_eff - 1,
            adaptive=False,
            f_args=obj_args,
            mesh=gp.mesh,
        )
        samples, f_vals = samples[:, 0, :], f_vals[:, 0]
        # The refreshed chains target the log posterior; split the prior
        # out of f_vals per the sampling_result contract.
        log_priors = sample_log_priors(gp, samples, fns, obj_args)
        f_vals = f_vals - log_priors
    sampling_result = {
        "samples": samples,
        "f_vals": f_vals.reshape(-1, 1),
        "log_priors": log_priors,
        "exit_flag": 0,
        "R": None,
        "eff_N": None,
        "ess_frac": ess_frac,
        "thin_eff": thin_eff,
        "n_evals": n_evals,
        "n_sweeps": n_sweeps,
    }
    with phase(gp.fit_timings, "posterior_s"):
        store_warm_state(gp, samples, sampling_result, 1, widths_w)
        gp.update(hyp=samples)
    return samples, None, sampling_result


def run_sampling(
    gp,
    *,
    sampler_name,
    options,
    s_N,
    thin,
    burn_in,
    widths,
    hyp_start,
    f_start,
    cand,
    cand_vals,
    LB,
    UB,
):
    """The sampling phase of ``GP.fit`` (reference
    gaussian_process.py:1232-1305 plus the oracle's sampler menu):
    dispatches on sampler and backend and returns ``(sampling_result,
    thin)``: thin comes back because MALA scales it by the number of
    hyperparameters (gplite_train.m:413, :424, :431).  "mala", "hmc" and
    "eissample" take their branch whatever ``sampler_backend`` and
    ``n_chains`` say.

    ``cand``/``cand_vals`` are the MAP phase's candidate pool (values may
    be None, evaluated lazily), used only for the non-finite-start
    fallback.
    """
    # Release the previous fit's factors (fit() has already validated the
    # sampler name: a bad 'sampler' must not leave a usable GP without
    # factors).
    release_posterior_factors(gp)
    eff_s_N = s_N * thin
    # 'covsample' (gplite_train.m:392-407) is eissample_lite with a
    # single walker: one random-direction slice move per iteration
    # instead of a full coordinate sweep (device backend only).
    slice_move = "rd" if sampler_name == "covsample" else "cw"
    if sampler_name == "mala":
        # MALA moves all dimensions at once: the gplite driver scales the
        # kept count, the burn-in and the thinning by the number of
        # hyperparameters, to keep the exploration per dimension
        # comparable to the coordinate-wise slice sampler.
        hyp_N = int(np.size(LB))
        thin = thin * hyp_N
        eff_s_N = s_N * thin
        burn_in = burn_in * hyp_N

    # Robustness guard: a float32 MAP point can sit where the objective is
    # borderline non-finite (Cholesky retry exhaustion); the samplers need
    # a finite start.  Fall back to the best finite candidate.
    if f_start is None:
        f_start = gp._objective(hyp_start)
    if not np.isfinite(f_start):
        cand = np.asarray(cand)
        vals = (
            gp._objective_batch(cand)
            if cand_vals is None
            else np.asarray(cand_vals)
        )
        finite = np.isfinite(vals)
        if not np.any(finite):
            raise ValueError(
                "No finite starting point for hyperparameter sampling "
                "(all candidates evaluate to Inf/NaN)."
            )
        hyp_start = cand[np.argmin(np.where(finite, vals, np.inf))]
        warnings.warn(
            "MAP optimum evaluated non-finite; starting MCMC from the best "
            "finite candidate instead.",
            stacklevel=2,
        )

    backend = options.get("sampler_backend", "device")
    width_base = options.get("sample_width_base", True)
    if sampler_name in ("mala", "hmc", "eissample"):
        sampling_result = _run_mala_hmc_ensemble(
            gp, sampler_name, options, eff_s_N, burn_in, widths, hyp_start,
            LB, UB,
        )
    elif backend == "device" and int(options.get("n_chains", 1)) > 1:
        sampling_result = _run_chain_parallel(
            gp, options, s_N, eff_s_N, burn_in, widths, hyp_start, LB, UB,
            slice_move,
        )
    elif backend == "device":
        fns, obj_args = gp._obj_args()
        sampling_result, state = _device_slice.sample(
            fns["log_post_chain_raw"],
            hyp_start,
            _new_stream(),
            widths=widths,
            LB=LB,
            UB=UB,
            n_samples=eff_s_N,
            thin=1,
            burn=burn_in,
            f_args=obj_args,
            step_out=options.get("step_out", False),
            diagnostics=options.get("sampler_diagnostics", True),
            display=options.get("display", "off"),
            move=slice_move,
            width_base=width_base,
        )
        # The widths the chain sampled with, after its burn-in.
        sampling_result["widths"] = state.widths
    else:
        if sampler_name == "covsample":
            raise ValueError(
                "sampler='covsample' requires the device sampler backend "
                "(sampler_backend='device')."
            )
        sample_f = lambda hyp_: gp._objective(hyp_, swap_sign=True)
        sampler_opts = {"display": "off", "diagnostics": False,
                        "width_base": width_base}
        slicer = SliceSampler(sample_f, hyp_start, widths, LB, UB, sampler_opts)
        sampling_result = slicer.sample(eff_s_N, burn=burn_in)
        sampling_result["n_evals"] = slicer.func_count
    return sampling_result, thin


def _run_mala_hmc_ensemble(gp, sampler_name, options, eff_s_N, burn_in,
                           widths, hyp_start, LB, UB):
    """The MALA, HMC and ensemble slice chains (gplite_train.m:409-447 and
    the oracle's ensemble sampler): ``eff_s_N`` samples after ``burn_in``
    steps or iterations from the MAP point (the ensemble's walkers start
    from a jittered cloud around it)."""
    fns, obj_args = gp._obj_args()
    common = dict(
        n_samples=eff_s_N,
        widths=widths,
        LB=LB,
        UB=UB,
        burn=burn_in,
        f_args=obj_args,
        log_prior=None if gp.no_prior else fns["log_prior_raw"],
        diagnostics=options.get("sampler_diagnostics", True),
    )
    stream = _new_stream()
    if sampler_name == "mala":
        result, _ = _mala.sample(
            fns["log_post_raw"], hyp_start, stream,
            step_size=options.get("step_size", None), **common,
        )
    elif sampler_name == "hmc":
        result, _ = _hmc.sample(
            fns["log_post_raw"], hyp_start, stream,
            step_size=options.get("step_size", None),
            n_leapfrog=int(options.get("hmc_steps", 10)), **common,
        )
    else:
        result, _ = _ensemble_slice.sample(
            fns["log_post_chain_raw"], hyp_start, stream, **common,
        )
    return result


def _run_chain_parallel(gp, options, s_N, eff_s_N, burn_in, widths,
                        hyp_start, LB, UB, slice_move):
    """Chain-parallel slice sampling: B independent chains from the MAP
    point, run one after the other on the device.  Cross-chain split
    Gelman-Rubin replaces the single-chain split R-hat (more chains, a
    stronger diagnostic)."""
    fns, obj_args = gp._obj_args()
    stream = _new_stream()
    B = int(options.get("n_chains"))
    n_per = -(-eff_s_N // B)
    if n_per < 2 and options.get("sampler_diagnostics", True) and B >= 2:
        # Cross-chain R-hat needs within-chain variance: with one draw
        # per chain W = 0/0.  Collect two per chain and keep eff_s_N.
        n_per = 2
    # Burn-in is per-chain work: every chain adapts its widths and
    # forgets the start over the full burn window.
    starts = np.tile(np.reshape(hyp_start, (1, -1)), (B, 1))
    # Overdispersed starts (the Gelman-Rubin prerequisite): chain 0 stays
    # at the MAP point, the rest jitter by a fraction of the slice widths,
    # clipped to bounds.
    start_jit = float(options.get("chain_start_jitter", 0.1))
    if B > 1 and start_jit > 0:
        jrng = np.random.default_rng(int(np.random.randint(0, 2**31 - 1)))
        pert = (
            start_jit
            * np.asarray(widths, dtype=np.float64)
            * jrng.standard_normal((B - 1, starts.shape[1]))
        )
        starts[1:] = np.clip(starts[1:] + pert, LB, UB)
    # In-chain thinned collection: the same kept-draw count, each draw
    # chain_thin sweeps apart.
    chain_thin = max(1, int(options.get("chain_thin", 1)))
    chain_x, chain_f, n_evals, n_sweeps = _device_slice.sample_chains(
        fns["log_post_chain_raw"],
        starts,
        stream,
        widths=widths,
        LB=LB,
        UB=UB,
        n_samples=n_per,
        thin=chain_thin,
        burn=burn_in,
        f_args=obj_args,
        mesh=gp.mesh,
        move=slice_move,
        width_base=options.get("sample_width_base", True),
    )
    # Interleave iteration-major so thinning strides across all chains
    # evenly.
    samples = chain_x.transpose(1, 0, 2).reshape(-1, chain_x.shape[2])[:eff_s_N]
    f_vals = chain_f.T.reshape(-1)[:eff_s_N]
    # The chain targets the log posterior; split the prior out of f_vals
    # per the sampling_result contract.
    log_priors = sample_log_priors(gp, samples, fns, obj_args)
    f_vals = f_vals - log_priors
    if options.get("sampler_diagnostics", True) and B >= 2:
        # Cross-chain split R-hat (each chain's draws split in half -> 2B
        # sequences): plain cross-chain R-hat over 2 chains estimates the
        # between-chain variance with one degree of freedom.
        half = chain_x.shape[1] // 2
        if half >= 2:
            split_x = np.concatenate(
                [chain_x[:, :half], chain_x[:, half : 2 * half]], axis=0
            )
        else:
            # < 4 draws per chain: halves would be length-1 sequences.
            split_x = chain_x
        R = gelman_rubin(split_x)
        eff_N = effective_n(split_x)
        if np.any(R > 1.5):
            exit_flag = -3
        elif np.any(R > 1.1):
            exit_flag = -2
        elif np.any(eff_N < eff_s_N / 10.0):
            exit_flag = -1
        else:
            exit_flag = 1
    else:
        exit_flag, R, eff_N = 0, None, None
    return {
        "samples": samples,
        "f_vals": f_vals.reshape(-1, 1),
        "log_priors": log_priors,
        "exit_flag": exit_flag,
        "R": R,
        "eff_N": eff_N,
        "n_chains": B,
        "n_evals": n_evals,
        "n_sweeps": n_sweeps,
    }
