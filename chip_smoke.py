#!/usr/bin/env python3
"""Drive the PyTorch port (gpyreg_tpu_torch) once on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name and power limit, torch and CUDA versions;
   TF32 off for matmuls and convolutions;
2. build: compile both libraries (csrc/kernel_tile.cu and
   csrc/kernel_vjp.cu) from the checkout's sources, one nvcc each, both
   started at once; the seconds taken, each library's ptxas registers
   and spills, and the dynamic shared memory a block takes;
3. kernel tile vs plain: the forward tile against its plain PyTorch
   version on the card, all five profiles, at the shapes the paths give
   it: the self-covariance 16384 x 16384 with zero_diag, the
   cross-covariance of a full predict chunk (16384 x 16384) and of the
   ragged last chunk (16384 x 1696), D = 10, and the training
   self-covariance 4096 x 4096, D = 8 (all on the TMA store path); then
   the self-covariance of refit_slicelite_bench, 4100 x 4100, D = 8 (a
   multiple of 4, so on the TMA store path, with a ragged last 64-row
   tile); then the path without TMA (M % 4 != 0) at 4095 x 4095 self and
   4096 x 4095 cross, D = 8, and at the one-column cross-covariances of
   ``GP.sample``: 16384 x 1, D = 10 (config 5) and 4096 x 1, D = 8
   (fit_sample_bench); and the shapes of phase 9a: the self-covariances
   1024 x 1024 and 64 x 64 and the crosses 16388 x 1024, 16388 x 256 and
   16388 x 64, D = 10 (the TMA paths), and the one-column crosses of the
   4 rank-1 updates, (16384 + k) x 1 for k = 0..3 against the k-th new
   row, D = 10 (the path without TMA; k > 0 leaves a ragged last row
   tile); output warping's predict_quantile cross 16384 x 256, D = 10;
   and the matrix-free tier's shapes, D = 4: a CG / Lanczos panel 2048 x
   65536 and cg_predict's cross 65536 x 512 (phase 23), the panels
   2048 x 8192 and 128 x 8192 and the cross 8192 x 512 of phase 24 (TMA
   paths) and the pivoted Cholesky's one-column cross 8192 x 1 (the path
   without TMA); a panel's rows are data rows, at t2 = 0 against
   themselves, where the plain norm expansion leaves a rounding residue
   that the m1 profile turns into a 2e-3 error, so the panel and column
   checks take held-out rows of the same shapes; and the mesh group's
   shapes (phase 26), D = 10: a dist_exact slab, N_DE / P x N_DE (8192 x
   32768 on 4 shards; held-out rows, for the same reason),
   dist_exact_predict's cross 8192 x 1024, and the ragged last chunk of a
   shard's config-5 predict, 16384 x 8616 on 4 shards.  Every self build is
   bitwise symmetric with its diagonal
   exactly sf2 * profile(0); each launch is counted on its path's key;
   sf2 and alpha are device tensors, as the main paths pass them, and at
   4096 x 4096 the time with Python floats (a host-to-device copy and a
   synchronisation per call) is printed beside it;
4. gradient tile vs plain: the one-pass gradient kernel against its
   plain version at N = 4096, D = 8 and N = 16384, D = 10 (TMA loads),
   and at N = 4095, D = 8 (the path without TMA), the five ARD profiles
   and se_iso, m1_iso, with the cotangent the training path gives it,
   0.5 G^-1 - alpha alpha^T of a real G = K + sn2 I (column-major, so
   read as its transpose); two launches bitwise equal; the Python-float
   time at N = 4096 as in phase 3;
5. the serving slice at full size (BASELINE.json config 5): an ARD-SE GP
   with constant mean and constant noise, N = 16384, D = 10, 8
   hyperparameter samples, float32, ``update`` then ``predict`` on
   100,000 test points, through the GP's default options; the kernel's
   launch counts prove the path ran through it;
6. full-size accuracy: 2 of those samples at 256 of the test points
   against a float64 build of the same GP on the card, at a tolerance set
   from a bound on the condition number of K + sn2 I;
7. accuracy: the same float32 GP on the card against the port's float64
   GP on the CPU, at N = 2048 and M = 4096, all 8 samples;
8. the training slice, bench.py's workload: an ARD-SE GP with constant
   mean and constant noise made with the public constructor, N = 4096,
   D = 8, float32, data and B = 8 hyperparameter vectors from seed 0 as
   bench.py makes them; the batched NLML value and gradient
   (``get_fns(...)["nlz_grad"]``) warmed up, then 3 rounds of 20
   iterations with bench.py's perturbation: the median evals/s, the peak
   device memory and the launches (B per iteration of each kernel); then
   ``GP.log_likelihood`` and ``GP.log_posterior`` (a Gaussian prior on
   every hyperparameter) with gradients, one launch of each kernel each;
   then 10 iterations of L-BFGS-B on the NLML from lane 0;
9. the training slice at config 5's size: the serving GP's 8 vectors,
   one batched NLML value and gradient at N = 16384, D = 10;
9a. the rest of serving on the config-5 serving GP (``serving_rest``):
    (a) 4 single-point ``update`` calls with rows of ``_data``'s function
    (N = 16384 to 16388), each timed, each exactly one 16384+k x 1 cross
    of the kernel tile a posterior (``cross_unaligned``) and no self build
    (no rebuild), with no sample falling back to a rebuild; then
    ``predict`` at 256 points against a float32 full rebuild of the same
    16388 rows and hyperparameters (timed), within max(1e-4, 10 kappa
    eps32) relative, kappa bounded as in phase 6, and where the updates
    matter: ``predict`` at the 4 new rows within the same rule, and each
    sample's ``alpha`` and the last 4 columns of its factor within the
    rule at that sample's kappa, relative to the rebuild's largest entry
    (printed beside how far the updates moved the mean at the new
    rows); (b) ``predict_full`` at
    1024 points: one 1024 x 1024 self and one 16388 x 1024 cross a
    posterior, the covariance exactly symmetric, its diagonal
    ``_group_predict``'s raw variance within 1e-4 relative to the prior
    variance, and 2 samples at 256 of the points against a float64 build
    on the card as in phase 6; (c) ``quad`` over 64 measures (``mu`` from
    the test points, ``sigma`` 0.5, ``compute_var``, ``separate_samples``),
    2 samples against the float64 build within the kappa rule; (d) one
    ``random_function`` draw at 1024 points (timed, with the route of its
    robust Cholesky), then 256 draws at 64 points under
    ``np.random.seed``, whose mean lies within 5 standard errors
    sqrt(s2/256) of ``predict``'s mixture mean at every point; (e)
    ``predict_quantile`` at 256 points, q = (0.1, 0.5, 0.9): finite and
    increasing in q; (f) ``fmin`` with 3 starts (timed, with its objective
    evaluations and its launches, none: the objective takes the plain
    composition): x in fmin's box and fval at most the mixture mean at the
    best training row + 1e-6 max(1, |fval|).  ``plot`` is not called (the
    card's machine has no matplotlib);
10. gradient accuracy: at N = 2048, D = 8, 8 lanes, the float32 card
    gradient against the port's float64 gradient on the CPU; at N = 4096,
    2 lanes against a float64 build on the card; per entry
    |dg| <= max(1e-3, 10 kappa eps32) max(|g64|, 1), kappa = cond(G);
11. fit_warm: a first small fit (N = 256, 8 design rows, 1 restart),
    which pays what a process pays once (the lazy imports of
    ``scipy.stats`` and ``scipy.optimize``), so that the two fits below
    time the fit alone; its seconds are printed;
12. fit_bench: ``GP.fit(options={"n_samples": 0})`` with the defaults
    (``init_N`` = 1024 design rows, ``opts_N`` = 3 restarts) on an ARD-SE
    GP with constant mean and constant noise, N = 4096, D = 8, float32,
    y a smooth function of X plus noise; prints the seconds of the design,
    the restarts and the posterior, and each restart's iterations, final
    objective and stop rule.  Checks: the MAP objective is finite and
    below the best design value; the returned restart's gradient in the
    unbounded space has inf-norm below 100 tol, or that restart stopped
    on the objective-drop rule (a restart that runs into a region where
    the float32 objective is noisier than the decrease it looks for stops
    on the step rule; it is printed and not returned); the float32 noise
    floor raised the noise's lower
    bound and the MAP noise respects it; the gradient tile was launched at
    least once per iteration and the kernel tile at least once per design
    row and per gradient; nothing ran on the paths without TMA; the
    float32 MAP objective is within max(1e-3, 10 kappa eps32)
    max(|f64|, 1) of the float64 objective at the same hyperparameters;
13. fit_config5: the same at full width, N = 16384, D = 10, with the
    design and restart counts of benchmarks/workloads.py:136, :185
    (``init_N`` = 256, ``opts_N`` = 2), without the float64 comparison;
14. fit_sample_bench: ``GP.fit`` with hyperposterior sampling and its
    defaults (slicesample, ``n_samples`` 10, ``thin`` 5, ``burn`` 50,
    ``init_N`` 1024, ``opts_N`` 3) on the data of fit_bench (N = 4096,
    D = 8, float32);
15. fit_sample_config5: the same at N = 16384, D = 10 with ``init_N`` 256,
    ``opts_N`` 2, ``n_samples`` 8, and the chain cut to ``burn`` 4 and
    ``thin`` 1 (12 sweeps, not the default 80);
16. refit_slicelite_bench: a ``fit`` with the sampler "slicelite" on the
    fit_sample_bench GP after 4 more rows of the same function (N = 4100):
    it must take the warm-refit shortcut (no design, no MAP);
17. covsample_chains_bench: N = 4096, the random-direction sampler
    "covsample" in 2 chains, ``n_samples`` 10, ``init_N`` 256, ``opts_N`` 1;
18. gp_sample: ``GP.sample(100)`` on the fit_sample_config5 GP (8
    posteriors, N = 16384) and ``GP.sample(50, beta=0.5)`` on the
    fit_sample_bench GP (10 posteriors, N = 4096), rebuilt from its data
    and samples because the refit of phase 16 changed that GP;
19. fit_mala_bench: ``GP.fit`` with the sampler "mala" on fit_bench's data
    (N = 4096, D = 8), ``init_N`` 256, ``opts_N`` 1, the other defaults
    (thin and burn-in scaled by the 11 hyperparameters: 1,100 steps);
20. fit_hmc_bench: the same with "hmc", ``hmc_steps`` 10 (100 iterations);
21. fit_eissample_bench: the same with "eissample" (24 walkers, 53
    iterations);
22. fit_mala_config5: "mala" at N = 16384, D = 10, ``init_N`` 256,
    ``opts_N`` 2, ``n_samples`` 8, the chain cut to ``thin`` 1, ``burn`` 2
    (130 steps, not the default 1,040);
23. cg_65536, the matrix-free tier at full width: the workload of
    benchmarks/matrix_free_sampling.py, part A (N = 65,536, D = 4,
    ARD-SE, constant mean and noise, float32, data from
    ``np.random.default_rng(0)`` as that script makes it, 512 held-out
    points), ``GP.fit`` with its CG_OPTS, ``"method": "auto"`` (the size
    rule picks CG), ``n_samples`` 0 and ``cg_max_opt_iter`` cut from 40 to
    10; then ``predict`` at the 512 points, then ``save``/``load`` and
    ``predict`` again.  Prints ``design_s``, ``optimize_s``, the CG
    iterations of every evaluation (``res.cg_iters``, with those at
    ``cg_max_iter``), ms a matvec, and the predict's iterations and
    relative residuals (``GP.cg_report``).  Checks: the fit took the CG
    path; every launch of the fit and predict is a kernel-tile cross,
    N / row_chunk = 32 a matvec (counted by wrapping
    ``ops.iterative._panel_matvec``), plus one 65536 x 512 cross for the
    predict; the peak allocated memory stays below 8 GiB (one
    materialized 65,536² float32 K is 17.2 GB); finite moments of shape
    (512, 1); the reloaded GP predicts the same values bit for bit;
24. cg_fidelity_8192, the same workload at part B's N = 8,192: a CG fit
    (``method`` "cg", the same cut) gives the MAP; ``cg_nlml`` at the MAP
    and 4 perturbations of it (0.05 normal), at the settings of
    tests/test_iterative.py:233-264 (row_chunk 128, 16 probes, 40
    Lanczos steps), against the port's exact float64 NLML and gradient on
    the card: the value within that test's 1%; the gradient within its
    0.15 max(|g64|, 1), or, at a point where an entry exceeds that, within
    the larger of it and 4 standard errors of the Hutchinson mean (from
    the per-probe gradients) + 1e-2 max(|g64|, 1), with both printed;
    ``cg_predict`` with and without ``cg_precond_rank`` 32 against the
    exact float64 ``predict`` within 10 kappa max(residual, eps32)
    relative, kappa(G) bounded by power iteration, with the iterations
    and residuals printed; the fixed-probe chain (``n_samples`` 3,
    ``thin`` 1, ``burn`` 1: 4 sweeps, cut; each density at the loose CG
    budget of benchmarks/matrix_free_sampling.py's chain, tol 1e-2 and 48
    iterations) from the MAP, each kept sample's value equal to the
    recomputed frozen-probe log posterior within 1e-6 relative;
25. outwarp: output warping at config 5's width (N = 16384, D = 10,
    ARD-SE, float32, ``NegativePowerC1``, y = -|x|^2/2 + 0.1 noise, a log
    density with a heavy lower tail): a MAP ``fit`` with fit_config5's
    ``init_N`` 256 and ``opts_N`` 2 (both tiles on the path: self
    launches at least the design rows plus the gradients, gradient-tile
    launches at least the iterations), ``predict`` at 100,000 points
    with ``return_lpd`` on held-out y (finite; one cross a chunk),
    ``predict_quantile`` at 256 points (finite, increasing in q); the
    float32 ``log_likelihood`` value and gradient against float64 on the
    card within max(1e-3, 10 kappa eps32); then a slice-sampled warped
    fit at fit_sample_bench's size (N = 4096, D = 8), its chain cut as
    fit_sample_config5's (8 samples, burn 4, thin 1), with the checks of
    the sampled fits;
26. the mesh group (``parallel/``), on a mesh of the first 2 or 4 cards
    where the host has two or more (a power of two keeps every shard's
    shapes on the TMA paths), else of 4 shards on the one card (printed;
    at least 2 shards).  The kappa rule is 10 kappa eps32 relative with
    kappa bounded as in phase 6.  (a) ``dist_exact_fit`` at N = 32768,
    D = 10 (``_data``'s function, ARD-SE, constant mean, the noise fixed
    at sn = 0.1), float32, b = 512, with ``algorithm`` "masked_full" and
    "two_level": the NLML within min(kappa rule, 1e-4) relative of the
    single-device float32 ``nlz`` and of the float64 ``nlz`` on the card,
    the two algorithms (one code path) bitwise equal, every slab's strict
    upper triangle exactly zero, exactly P kernel-tile crosses of
    (N / P) x N; then a padded fit on the first N_DE_PAD rows (not a
    multiple of P b: the last shard's padded rows run) within the same
    rule of the float64 ``nlz`` of those rows, its padded alpha rows
    exactly zero;
    ``dist_exact_predict`` at 1,024 points (P crosses of (N / P) x 1024)
    against the single-device ``GP.predict`` of the same hyperparameters
    within the kappa rule; prints build + factor, solve and predict
    seconds, peak memory and the slab bytes a shard; (b) ``GP(mesh=...)``
    at config 5 (N = 16384, D = 10, 8 samples): ``predict`` at the
    100,000 test points within 1e-5 of the single-device GP's, relative
    to max |mu| and to the prior variance, timed beside phase 5's and
    the single device's, one cross a chunk of each shard's points; ``quad``
    over 64 measures within the kappa rule of the single device's; (c)
    ``sharded_nlml_grad`` at bench.py's workload, B = 8 and 7 (padded to
    the mesh): values and gradients within 1e-6 of ``nlz_grad``'s, B
    kernel-tile self builds and B gradient tiles; (d) ``GP(mesh=...).fit``
    at fit_bench's size and options: the MAP objective within max(1e-3,
    10 kappa eps32) max(1, |f|) of phase 12's, and on a mesh of one card
    the fit bitwise equal to phase 12's, the launch checks of phase 12;
    then
    ``n_chains`` 8 over the mesh (``init_N`` 256, ``opts_N`` 1, 8
    samples, the chain cut to burn 4, thin 1) with the checks of the
    sampled fits; (e) ``sharded_cg_weights`` at phase 23's 65,536 rows,
    D = 4, its MAP, tol 1e-5: the relative residual |r - (K + sn2 I)
    alpha| / |r| recomputed by the single-device ``_panel_matvec`` at
    most max(2 tol, twice that of ``cg_posterior_weights``' alpha from
    the same solve on one device: float32 CG at this conditioning ends
    with a true residual above its recursion's, printed for both, with a
    float64 recomputation beside), the mean at its 512 points from alpha
    within 1e-3 relative of ``cg_posterior_weights``', one kernel-tile
    cross a 2048-row panel; prints the iterations and ms a sharded
    matvec beside phase 23's.

For each sampled fit it prints the phase seconds, ``n_evals`` (density
calls), ms a density, densities a move (``n_evals`` over sweeps and free
dimensions), the exit flag, max R-hat, min eff_N, the post-burn widths
and the peak memory.  Checks: the samples lie in the fit's bounds (with
the float32 noise floor); each sample's f_vals + log_priors is its log
posterior recomputed on the card within 1e-5 relative (and, at
fit_sample_bench, two samples are within max(1e-3, 10 kappa eps32) of
the float64 log posterior); the kernel tile's self launches in the
chain's window are at least ``n_evals`` (the rest are jitter retries,
printed); the gradient tile ran at least once per L-BFGS iteration;
nothing ran on the cross keys or a path without TMA; every posterior's
alpha is finite.  For gp_sample: finite samples in bounds, only
``cross_unaligned`` launches, a positive multiple of the posterior
count, and at 3 samples the density (the float32 mixture mean) within
1e-4 relative of the mixture mean of a float64 build's ``predict``.
Short chains may flag non-convergence; that is printed, not checked.

For phases 19-22 it prints the phase seconds, the chain's density calls
(value and gradient for MALA and HMC, counted by wrapping the density the
sampler is given), its steps (counted on its random stream), ms a step
(an iteration, a walker move), ms a call, the acceptance rate, the exit
flag, max R-hat and min eff_N.  Checks: those of the sampled fits above
on the samples, their values and the chain's self launches; the gradient
tile launched at least once a value-and-gradient call in the MALA and
HMC chains' windows and never in the ensemble chain's; at fit_mala_bench,
the float32 value and gradient of ``log_post_raw`` at the last two kept
samples within max(1e-3, 10 kappa eps32) of a float64 build's.

Prints a JSON line of per-kernel results, then the card's name and power
limit, then, last, the ``{"ok": true, "device": ...}`` line.  Imports
nothing of JAX.  Exits non-zero, with no result, when no CUDA device is
available.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
D = 10
N = 16384
S = 8
M_TEST = 100_000
N_ACC, M_ACC = 2048, 4096
S_FULL, M_FULL = 2, 256
# Training: bench.py's workload (bench.py:39, :48-57, :77).
N_TR, D_TR, B_TR = 4096, 8, 8
ROUNDS, ITERS = 3, 20
LBFGS_ITERS = 10
N_GACC, S_GACC_FULL = 2048, 2
# The two fits: (N, D, options).  fit_bench takes GP.fit's defaults.
FIT_BENCH = (N_TR, D_TR, {"n_samples": 0})
FIT_CONFIG5 = (N, D, {"n_samples": 0, "init_N": 256, "opts_N": 2})
FIT_NOISE = 0.3
# The sampled fits: (name, N, D, options).  fit_sample_bench takes
# GP.fit's defaults; fit_sample_config5 cuts the chain (burn 4, thin 1:
# 12 sweeps for 8 samples, not 80) to keep the script inside its time.
FIT_SAMPLE_BENCH = ("fit_sample_bench", N_TR, D_TR, {})
FIT_SAMPLE_CONFIG5 = ("fit_sample_config5", N, D,
                      {"init_N": 256, "opts_N": 2, "n_samples": 8, "burn": 4,
                       "thin": 1})
COVSAMPLE_CHAINS = ("covsample_chains_bench", N_TR, D_TR,
                    {"sampler": "covsample", "n_chains": 2, "n_samples": 10,
                     "init_N": 256, "opts_N": 1})
# The gradient samplers' and the ensemble sampler's fits on fit_bench's
# data, and MALA at config 5 with its chain cut to thin 1, burn 2: 104 kept
# and 26 burn-in steps, not the default 1,040.
FIT_MALA_BENCH = ("fit_mala_bench", N_TR, D_TR,
                  {"sampler": "mala", "init_N": 256, "opts_N": 1})
FIT_HMC_BENCH = ("fit_hmc_bench", N_TR, D_TR,
                 {"sampler": "hmc", "hmc_steps": 10, "init_N": 256, "opts_N": 1})
FIT_EISSAMPLE_BENCH = ("fit_eissample_bench", N_TR, D_TR,
                       {"sampler": "eissample", "init_N": 256, "opts_N": 1})
FIT_MALA_CONFIG5 = ("fit_mala_config5", N, D,
                    {"sampler": "mala", "init_N": 256, "opts_N": 2,
                     "n_samples": 8, "thin": 1, "burn": 2})
REFIT_ROWS = 4
GP_SAMPLE_N = (100, 50)
# Phase 9a: single-point updates, then the test points of predict_full,
# quad's measures, random_function's draws and predict_quantile's points.
R1_ROWS = 4
M_PF, M_QUAD, M_RF, N_RF, M_Q = 1024, 64, 64, 256, 256
# The matrix-free tier: benchmarks/matrix_free_sampling.py's workload,
# part A at N_CG rows and part B at N_CG_B, D = 4, its CG_OPTS with method
# "auto" (the size rule picks CG at N_CG) and cg_max_opt_iter cut from 40
# to CG_OPT_ITERS; M_CG held-out points.
N_CG, D_CG, N_CG_B, M_CG = 65536, 4, 8192, 512
CG_OPT_ITERS = 10
CG_OPTS = {"method": "auto", "cg_row_chunk": 2048, "cg_n_probes": 8,
           "cg_n_lanczos": 24, "cg_tol": 1e-4, "cg_max_iter": 300,
           "cg_max_opt_iter": CG_OPT_ITERS, "cg_init_N": 8,
           "cg_predict_tol": 1e-5, "tol_opt": 1e-5, "n_samples": 0}
# The estimator's settings and bounds in tests/test_iterative.py:233-264
# (its gradient bound held to the probes' standard error where that is the
# larger, phase_cg_fidelity).
CG_EST = {"row_chunk": 128, "n_probes": 16, "n_lanczos": 40}
CG_EST_VALUE_TOL, CG_EST_GRAD_TOL = 0.01, 0.15
CG_PEAK_BYTES = 8 * 2**30
CG_PRECOND_RANK = 32
# The fixed-probe chain at N_CG_B, cut to 3 kept samples after 1 burn-in
# sweep (4 sweeps), each density at the loose CG budget of
# benchmarks/matrix_free_sampling.py's chain (tol 1e-2, 48 iterations).
CG_CHAIN = {"n_samples": 3, "thin": 1, "burn": 1, "cg_sample_tol": 1e-2,
            "cg_sample_max_iter": 48}
# Output warping: a MAP fit at config 5's width with fit_config5's design
# and restarts, and a sampled fit at fit_sample_bench's size with its
# chain cut as fit_sample_config5's (burn 4, thin 1, 8 samples).
OW_MAP = {"n_samples": 0, "init_N": 256, "opts_N": 2}
OW_SAMPLE = {"n_samples": 8, "burn": 4, "thin": 1}
# The mesh group: its shards on one card; dist_exact at config 5's width
# with twice its rows (N_DE, panels of DE_B), predict at M_DE points; the
# sharded CG's iteration cap; the chains of GP(mesh=...).fit at
# fit_bench's size, 8 of them, cut as fit_sample_config5's chain.
MESH_SHARDS = 4
N_DE, DE_B, M_DE = 32768, 512, 1024
N_DE_PAD = 30000
MESH_CG_MAX_ITER = 500
MESH_CHAINS = ("mesh_chains_bench", N_TR, D_TR,
               {"n_chains": 8, "n_samples": 8, "burn": 4, "thin": 1,
                "init_N": 256, "opts_N": 1})
VJP_COVS = ("se", "m1", "m3", "m5", "rq", "se_iso", "m1_iso")
# Kernel (direct differences) vs the plain norm-expansion version in
# float32, the tolerance of tests/test_fused_kernel.py:46.
KERNEL_TOL = 1e-5
# Gradient tile vs its plain version, per entry, scaled by
# max(|g_plain|, 1): the bound of tests/test_fused_kernel.py:58.
VJP_RTOL = 1e-4
EPS32 = float(np.finfo(np.float32).eps)
# Published NVIDIA H100 SXM peaks at 700 W: HBM3 bandwidth and FP32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
DEV = torch.device("cuda")


def _data(n, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + 0.1 * rng.normal(size=(n, 1))
    xs = rng.normal(size=(m, D))
    # ARD-SE | log sigma_n | mean: near a sensible fit for this data.
    hyp = np.zeros((S, D + 3))
    hyp[:, D + 1] = np.log(0.1)
    hyp += 0.05 * rng.normal(size=hyp.shape)
    return X, y, xs, hyp


def _new_rows(k, seed):
    """k more rows of ``_data``'s function, from its generator."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(k, D))
    return X, (np.sum(np.sin(X), axis=1, keepdims=True)
               + 0.1 * rng.normal(size=(k, 1)))


def _train_data(n, seed):
    """bench.py's inputs (bench.py:48-57): float32 X, y and B
    hyperparameter vectors, returned as float64 arrays of those values."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D_TR)).astype(np.float32)
    y = (np.sum(np.sin(X), axis=1, keepdims=True)
         + 0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    hyps = (0.05 * rng.normal(size=(B_TR, D_TR + 3))).astype(np.float32)
    return (a.astype(np.float64) for a in (X, y, hyps))


def _se_gp(d, dtype, device=None, outwarp=None, mesh=None):
    import gpyreg_tpu_torch as gt

    return gt.GP(
        d,
        gt.covariance_functions.SquaredExponential(),
        gt.mean_functions.ConstantMean(),
        gt.noise_functions.GaussianNoise(constant_add=True),
        dtype=dtype,
        outwarp=outwarp,
        device=DEV if device is None else device,
        mesh=mesh,
    )


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _turns(kernel, plain, reps):
    """Kernel and plain ms, two runs each in the order plain, kernel,
    kernel, plain; returns (mean kernel, mean plain, runs, runs)."""
    t_plain = [_time_ms(plain, reps)]
    t_kern = [_time_ms(kernel, reps), _time_ms(kernel, reps)]
    t_plain.append(_time_ms(plain, reps))
    return float(np.mean(t_kern)), float(np.mean(t_plain)), t_kern, t_plain


def _bound(nbytes, flops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the FP32 operations over the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tile_bound(n, m, d, self_cov=False):
    """Kernel tile: reads Xs and Zs, writes K; 3 FP32 operations per
    entry and dimension (a subtraction and a fused multiply-add), on one
    half of a self-covariance (the other half is its mirror)."""
    entries = n * (n + 1) // 2 if self_cov else n * m
    return _bound(4 * (n * m + (n + m) * d), entries * 3 * d)


def _vjp_bound(n, d, iso):
    """Gradient tile: reads Gbar and Xs once, writes the gradient row;
    the sum of Gbar_ij and Gbar_ji (1 operation), then per entry of one
    half of the plane 3 operations per dimension for t2, 2 more per
    dimension for the ARD contraction (with the squared differences
    kept), and 6 for the profile, E and the sums."""
    return _bound(4 * (n * n + n * d + d + 2),
                  n * n + n * (n + 1) // 2 * ((3 if iso else 5) * d + 6))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    import re

    from gpyreg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    tile_lib = _build.kernel_tile_lib()
    vjp_lib = _build.kernel_vjp_lib()
    secs = time.perf_counter() - t0
    print(f"build: {', '.join(libs)} in {secs:.2f} s (one nvcc each, "
          f"started together)")
    for name, path in libs.items():
        with open(path[: -len(".so")] + ".log") as f:
            log = f.read()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
        print(f"  {name} -> {os.path.relpath(path)}: ptxas {len(regs)} "
              f"kernels, {min(regs)}-{max(regs)} registers a thread, "
              f"{max(spills)} bytes of spills at most")
        if max(spills):
            raise AssertionError(f"{name}: ptxas reports spills")
    print(f"  dynamic shared memory a block: kernel_tile "
          f"{tile_lib.kernel_tile_smem_bytes()} B, kernel_vjp "
          f"{vjp_lib.kernel_vjp_smem_bytes(D + 1)} B at D = {D}")
    return secs


def _chunks():
    """The test-point chunk of the slice's predict and its ragged tail."""
    from gpyreg_tpu_torch.gp import _PREDICT_CHUNK_ELEMS

    chunk = min(M_TEST, _PREDICT_CHUNK_ELEMS // N)
    return chunk, M_TEST - chunk * ((M_TEST - 1) // chunk)


def _device_params():
    """sf2 and alpha as the main paths hand them to the kernels: float32
    tensors on the card (``ops.kernels.cov_params``)."""
    from gpyreg_tpu_torch.ops.kernels import cov_params

    h = torch.tensor([0.0, 0.1, 0.3], dtype=torch.float32, device=DEV)
    _, sf2, alpha = cov_params("rq", False, h, torch.zeros((1, 1), device=DEV))
    return sf2, alpha


def _one_launch(TK, key, fn):
    """fn() with the launch counts set to 0 before; checks that it made
    one launch, on ``key``."""
    TK.reset_launches()
    out = fn()
    want = {**dict.fromkeys(TK.LAUNCHES, 0), key: 1}
    if TK.LAUNCHES != want:
        raise AssertionError(f"launches {TK.LAUNCHES}, expected one {key}")
    return out


def phase_kernel_vs_plain(X, xs, X_tr, cg, extra):
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    chunk, tail = _chunks()
    Xs = torch.as_tensor(X, dtype=torch.float32, device=DEV)
    # Phase 9a's data: the serving rows and the 4 rows of its updates.
    Xg = torch.cat([Xs, torch.as_tensor(_new_rows(R1_ROWS, SEED + 7)[0],
                                        dtype=torch.float32, device=DEV)])
    Zp = torch.as_tensor(xs[:M_PF], dtype=torch.float32, device=DEV)
    Zc = torch.as_tensor(xs[:chunk], dtype=torch.float32, device=DEV)
    Zt = torch.as_tensor(xs[-tail:], dtype=torch.float32, device=DEV)
    Xt = torch.as_tensor(X_tr, dtype=torch.float32, device=DEV)
    # N and M = 4095: the path without TMA.  The cross case takes fresh
    # points: rows shared with Xt would be duplicates at t2 = 0, where the
    # plain version's norm expansion leaves a rounding residue that the m1
    # profile turns into a 3e-3 error.
    Xu = Xt[:N_TR - 1].contiguous()
    Zu = torch.as_tensor(np.random.default_rng(SEED + 2).normal(
        size=(N_TR - 1, Xt.shape[1])), dtype=torch.float32, device=DEV)
    # refit_slicelite_bench's N = 4100 = 64 * 64 + 4.
    Xr = torch.cat([Xt, torch.as_tensor(np.random.default_rng(SEED + 6).normal(
        size=(REFIT_ROWS, Xt.shape[1])), dtype=torch.float32, device=DEV)])
    # The matrix-free tier's shapes: its panels and crosses at N_CG and
    # N_CG_B rows, D = 4, and the pivoted Cholesky's one-column cross.  A
    # panel's rows are data rows, at t2 = 0 against themselves, where the
    # plain version's rounding residue turns into a 2e-3 error under the
    # m1 profile: the checks take held-out rows of the same shapes.
    Xcg, Zcg, Xcb, Zcb = (torch.as_tensor(a, dtype=torch.float32, device=DEV)
                          for a in (cg[0], cg[2], cg[3], cg[5]))
    rc = CG_OPTS["cg_row_chunk"]
    Pcg = torch.as_tensor(np.random.default_rng(SEED + 12).normal(
        size=(rc, D_CG)), dtype=torch.float32, device=DEV)
    sf2, alpha = _device_params()
    results = {}
    for use, key, (A, B, zd, reps) in (
        ("self", "self", (Xs, Xs, True, 5)),
        ("cross", "cross", (Xs, Zc, False, 5)),
        ("cross_tail", "cross", (Xs, Zt, False, 20)),
        ("self_train", "self", (Xt, Xt, True, 20)),
        ("self_refit", "self", (Xr, Xr, True, 20)),
        ("self_unaligned", "self_unaligned", (Xu, Xu, True, 20)),
        ("cross_unaligned", "cross_unaligned", (Xt, Zu, False, 20)),
        # GP.sample's density: one column per posterior, at config 5 and
        # at fit_sample_bench's N = 4096, D = 8.
        ("cross_col", "cross_unaligned", (Xs, Zc[:1].contiguous(), False, 50)),
        ("cross_col_bench", "cross_unaligned",
         (Xt, Zu[:1].contiguous(), False, 50)),
        # Phase 9a: predict_full and random_function at 1024 points, the
        # draws at 64, predict and predict_quantile at 256.
        ("self_pf", "self", (Zp, Zp, True, 20)),
        ("cross_pf", "cross", (Xg, Zp, False, 10)),
        ("self_64", "self", (Zp[:M_RF], Zp[:M_RF], True, 50)),
        ("cross_64", "cross", (Xg, Zp[:M_RF], False, 20)),
        ("cross_256", "cross", (Xg, Zp[:M_Q], False, 20)),
        # The rank-1 updates: the rows so far against the next new row.
        *((f"cross_r1_{k}", "cross_unaligned",
           (Xg[: N + k], Xg[N + k : N + k + 1], False, 20))
          for k in range(R1_ROWS)),
        # Output warping's predict_quantile: 16384 x 256.
        ("cross_256_ow", "cross", (Xs, Zp[:M_Q], False, 20)),
        # The matrix-free tier: a CG / Lanczos panel and cg_predict's cross
        # at N_CG; at N_CG_B the fit's and predict's panel, the
        # estimator's panel (row_chunk 128) and cross, and the pivoted
        # Cholesky's column (no TMA).
        ("cg_panel", "cross", (Pcg, Xcg, False, 5)),
        ("cg_cross", "cross", (Xcg, Zcg, False, 5)),
        ("cg_panel_8192", "cross", (Pcg, Xcb, False, 20)),
        ("cg_panel_128", "cross", (Pcg[:CG_EST["row_chunk"]], Xcb, False, 20)),
        ("cg_cross_8192", "cross", (Xcb, Zcb, False, 20)),
        ("cg_column_8192", "cross_unaligned",
         (Xcb, Zcb[:1].contiguous(), False, 50)),
        # The mesh group's shapes (_mesh_checks).
        *extra,
    ):
        for base in TK.PROFILES:
            K = _one_launch(TK, key, lambda: TK.kernel_cross(
                base, A, B, sf2, alpha, zero_diag=zd))
            ref = TK.kernel_cross_ref(base, A, B, sf2, alpha, zero_diag=zd)
            torch.cuda.synchronize()
            err = torch.max(torch.abs(K - ref)).item()
            del ref
            if zd:
                k0 = TK.kernel_cross_ref(base, A[:1], A[:1], sf2, alpha,
                                         zero_diag=True)[0, 0]
                if not (torch.equal(K, K.T)
                        and torch.all(torch.diagonal(K) == k0)):
                    raise AssertionError(
                        f"kernel_tile {use} {base}: the self build is not "
                        f"bitwise symmetric with diagonal sf2 * profile(0)")
            del K
            ms, plain_ms, t_kern, t_plain = _turns(
                lambda: TK.kernel_cross(base, A, B, sf2, alpha, zero_diag=zd),
                lambda: TK.kernel_cross_ref(base, A, B, sf2, alpha,
                                            zero_diag=zd),
                reps,
            )
            print(f"kernel_tile {use:15s} {base}: {A.shape[0]}x{B.shape[0]} "
                  f"D={A.shape[1]} path {key} max_abs_err={err:.3e} kernel "
                  f"{ms:.4f} ms (runs {t_kern}) plain {plain_ms:.4f} ms "
                  f"(runs {t_plain}){' symmetric' if zd else ''}")
            if not err < KERNEL_TOL:
                raise AssertionError(
                    f"kernel_tile {use} {base}: max abs error {err} "
                    f">= {KERNEL_TOL}"
                )
            results[(use, base)] = (err, ms, plain_ms, A.shape[0],
                                    B.shape[0], A.shape[1])
    # The cost of timing with Python floats: each is copied to the card,
    # with a synchronisation, on every call.
    f_sf2, f_alpha = sf2.item(), alpha.item()
    float_ms = _time_ms(lambda: TK.kernel_cross("se", Xt, Xt, f_sf2, f_alpha,
                                                zero_diag=True), 20)
    dev_ms = _time_ms(lambda: TK.kernel_cross("se", Xt, Xt, sf2, alpha,
                                              zero_diag=True), 20)
    print(f"kernel_tile self_train se {N_TR}x{N_TR}: device params "
          f"{dev_ms:.4f} ms, Python floats {float_ms:.4f} ms")
    results["python_float"] = (dev_ms, float_ms)
    return results


def _path_cotangent(X, y, hyp):
    """Xs = X / ell and the cotangent of K on the training path,
    Gbar = 0.5 G^-1 - alpha alpha^T with G = K + sn2 I, alpha = G^-1 r,
    for the ARD-SE vector ``hyp``, in float32 on the card."""
    from gpyreg_tpu_torch.ops.kernels import kernel_matrix

    d = X.shape[1]
    Xd = torch.as_tensor(X, dtype=torch.float32, device=DEV)
    h = torch.as_tensor(hyp, dtype=torch.float32, device=DEV)
    with torch.no_grad():
        G = kernel_matrix("se", h[: d + 1], Xd)
        G.diagonal().add_(torch.exp(2.0 * h[d + 1]))
        L = torch.linalg.cholesky(G)
        del G
        r = torch.as_tensor(y, dtype=torch.float32, device=DEV) - h[d + 2]
        a = torch.cholesky_solve(r, L).reshape(-1)
        Gbar = torch.cholesky_inverse(L)
        del L
        Gbar.mul_(0.5).addr_(a, a, alpha=-1.0)
    return (Xd / torch.exp(h[:d])).contiguous(), Gbar


def phase_vjp_vs_plain(cases):
    """``cases``: (label, X, y, hyp).  Returns {(label, cov): (err, rel,
    ms, plain_ms, n, d)}."""
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    sf2, alpha = _device_params()
    results = {}
    for label, X, y, hyp in cases:
        Xs, Gbar = _path_cotangent(X, y, hyp)
        n, d = Xs.shape
        key = "vjp" if n % 4 == 0 else "vjp_unaligned"
        reps = 20 if n <= 4096 else 3
        for cov in VJP_COVS:
            iso = cov.endswith("_iso")
            base = cov[:-4] if iso else cov
            g = _one_launch(TK, key, lambda: TK.vjp_tile(base, iso, Xs, Gbar,
                                                        sf2, alpha))
            ref = TK.vjp_tile_ref(base, iso, Xs, Gbar, sf2, alpha)
            torch.cuda.synchronize()
            err = torch.max(torch.abs(g - ref)).item()
            rel = torch.max(torch.abs(g - ref)
                            / torch.clamp(torch.abs(ref), min=1.0)).item()
            again = TK.vjp_tile(base, iso, Xs, Gbar, sf2, alpha)
            if not torch.equal(g, again):
                raise AssertionError(f"kernel_vjp {label} {cov}: two "
                                     f"launches differ")
            ms, plain_ms, t_kern, t_plain = _turns(
                lambda: TK.vjp_tile(base, iso, Xs, Gbar, sf2, alpha),
                lambda: TK.vjp_tile_ref(base, iso, Xs, Gbar, sf2, alpha),
                reps,
            )
            bound_ms, _ = _vjp_bound(n, d, iso)
            print(f"kernel_vjp {label} {cov}: N={n} D={d} path {key} width "
                  f"{g.numel()} "
                  f"max_abs_err={err:.3e} max rel err (scaled by "
                  f"max(|g_plain|, 1)) {rel:.3e} (bound {VJP_RTOL}); max "
                  f"|g| {torch.max(torch.abs(ref)).item():.4e}; kernel "
                  f"{ms:.4f} ms (runs {t_kern}) plain {plain_ms:.4f} ms "
                  f"(runs {t_plain}) bound {bound_ms:.4f} ms")
            if not rel < VJP_RTOL:
                raise AssertionError(
                    f"kernel_vjp {label} {cov}: max relative error {rel} "
                    f">= {VJP_RTOL}"
                )
            results[(label, cov)] = (err, rel, ms, plain_ms, n, d)
        if label == "bench":
            # With Python floats: a copy and a sync per call.
            f_sf2, f_alpha = sf2.item(), alpha.item()
            float_ms = _time_ms(lambda: TK.vjp_tile("se", False, Xs, Gbar,
                                                    f_sf2, f_alpha), reps)
            dev_ms = _time_ms(lambda: TK.vjp_tile("se", False, Xs, Gbar, sf2,
                                                  alpha), reps)
            print(f"kernel_vjp bench se N={n}: device params {dev_ms:.4f} ms, "
                  f"Python floats {float_ms:.4f} ms")
            results["python_float"] = (dev_ms, float_ms)
        del Xs, Gbar
        torch.cuda.empty_cache()
    return results


def phase_slice(X, y, xs, hyp):
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    gp = _se_gp(D, np.float32)
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    t0 = time.perf_counter()
    gp.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=True)
    torch.cuda.synchronize()
    t_post = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, s2 = gp.predict(xs)
    t_pred = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    chunk = gp._predict_chunk(N, M_TEST)
    n_chunks = -(-M_TEST // chunk)
    flags = [bool(p.L_chol) for p in gp.posteriors]
    print(f"slice: N={N} D={D} S={S} M={M_TEST} float32; posterior build "
          f"{t_post:.3f} s; predict {t_pred:.3f} s = {M_TEST / t_pred:.1f} "
          f"pts/s (chunk {chunk}, {n_chunks} chunks); L_chol={flags}; "
          f"sn2_mult={[p.sn2_mult for p in gp.posteriors]}; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    if mu.shape != (M_TEST, 1) or s2.shape != (M_TEST, 1):
        raise AssertionError(f"predict shapes {mu.shape}, {s2.shape}")
    if not (np.all(np.isfinite(mu)) and np.all(np.isfinite(s2))):
        raise AssertionError("predict returned non-finite values")
    want = {**dict.fromkeys(TK.LAUNCHES, 0), "self": S,
            "cross": S * n_chunks}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    return gp, launches, t_pred


def _kappa_bounds(X, hyps):
    """For each ARD-SE row of ``hyps``, the bound (lambda_max(K) + sn2) /
    sn2 on cond(K + sn2 I), lambda_max from 50 steps of power iteration
    in float64 on the card."""
    from gpyreg_tpu_torch.ops.kernels import kernel_matrix

    Xd = torch.as_tensor(X, device=DEV)
    n = Xd.shape[0]
    out = []
    for h in hyps:
        K = kernel_matrix("se", torch.as_tensor(h[: D + 1]), Xd)
        sn2 = float(np.exp(2 * h[D + 1]))
        v = torch.ones(n, dtype=K.dtype, device=K.device) / np.sqrt(n)
        for _ in range(50):
            v = K @ v
            v /= torch.linalg.norm(v)
        lam_max = float(v @ (K @ v))
        out.append((lam_max + sn2) / sn2)
        del K
    torch.cuda.empty_cache()
    return out


def phase_full_size_accuracy(gp32, X, y, xs, hyp):
    """The first S_FULL samples of the full-size float32 GP, at M_FULL test
    points spread over all chunks, against a float64 build of the same GP
    on the card.  Raw predictive variances (before ``predict`` clamps them
    at 0) are compared.  The float32 solves lose about kappa * eps32
    relative accuracy, with kappa = cond(K + sn2 I) <= (lambda_max(K) +
    sn2) / sn2 (K is positive semi-definite); lambda_max comes from power
    iteration in float64."""
    from gpyreg_tpu_torch.convert import gp_from_arrays

    sub = xs[:: M_TEST // M_FULL][:M_FULL]
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0], "dtype": "float64"}
    gp64 = gp_from_arrays(meta, X, y, None, hyp[:S_FULL], DEV)
    mu64, s264 = gp64._group_predict(sub)
    del gp64
    mu32, s232 = gp32._group_predict(sub)
    mu32, s232 = mu32[:, :S_FULL], s232[:, :S_FULL]

    kappa = max(_kappa_bounds(X, hyp[:S_FULL]))
    rel = 10.0 * kappa * EPS32
    tol_mu = rel * max(1.0, float(np.max(np.abs(mu64))))
    tol_s2 = rel * float(np.exp(2 * hyp[:S_FULL, D].max()))
    err_mu = float(np.max(np.abs(mu32 - mu64)))
    err_s2 = float(np.max(np.abs(s232 - s264)))
    print(f"full-size accuracy: N={N} M={M_FULL} of {M_TEST} S={S_FULL}, "
          f"float32 vs float64 on the card: max|dmu|={err_mu:.3e} (tol "
          f"{tol_mu:.3e}), max|ds2|={err_s2:.3e} (tol {tol_s2:.3e}), raw "
          f"s2 in [{float(np.min(s232)):.3e}, {float(np.max(s232)):.3e}]; "
          f"kappa(G) <= {kappa:.1f}, tol = 10*kappa*eps32 relative")
    if not (err_mu < tol_mu and err_s2 < tol_s2):
        raise AssertionError("full-size float32 GP disagrees with float64")


def _kappa(X, hyp):
    """cond(G) of the ARD-SE G = K + sn2 I, from its eigenvalues in
    float64 on X's device."""
    from gpyreg_tpu_torch.ops.kernels import kernel_matrix

    d = X.shape[1]
    K = kernel_matrix("se", torch.as_tensor(hyp[: d + 1], device=X.device), X)
    K.diagonal().add_(float(np.exp(2 * hyp[d + 1])))
    lam = torch.linalg.eigvalsh(K)
    return float(lam[-1] / lam[0])


def phase_accuracy():
    from gpyreg_tpu_torch.convert import gp_from_arrays

    X, y, xs, hyp = _data(N_ACC, M_ACC, SEED + 1)
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0]}
    gp32 = gp_from_arrays({**meta, "dtype": "float32"}, X, y, None, hyp, DEV)
    gp64 = gp_from_arrays({**meta, "dtype": "float64"}, X, y, None, hyp, "cpu")
    mu32, s232 = gp32.predict(xs, separate_samples=True)
    mu64, s264 = gp64.predict(xs, separate_samples=True)

    # Conditioning of the first sample's G = K + sn2 I in float64 on the
    # CPU: the float32 solves lose about kappa * eps32 relative accuracy.
    kappa = _kappa(torch.as_tensor(X), hyp[0])
    rel = max(1e-4, 10.0 * kappa * EPS32)
    sf2_max = float(np.exp(2 * hyp[:, D].max()))
    tol_mu = rel * max(1.0, float(np.max(np.abs(mu64))))
    tol_s2 = rel * sf2_max
    err_mu = float(np.max(np.abs(mu32 - mu64)))
    err_s2 = float(np.max(np.abs(s232 - s264)))
    print(f"accuracy: N={N_ACC} M={M_ACC} S={S}, float32 card vs float64 CPU: "
          f"max|dmu|={err_mu:.3e} (tol {tol_mu:.3e}), max|ds2|={err_s2:.3e} "
          f"(tol {tol_s2:.3e}); kappa(G)={kappa:.1f}, tol = max(1e-4, "
          f"10*kappa*eps32) relative")
    if not (err_mu < tol_mu and err_s2 < tol_s2):
        raise AssertionError("float32 card GP disagrees with float64 CPU GP")


def _check_finite(v, g, lanes, width, what):
    if tuple(v.shape) != (lanes,) or tuple(g.shape) != (lanes, width):
        raise AssertionError(f"{what}: shapes {tuple(v.shape)}, "
                             f"{tuple(g.shape)}")
    if not (torch.all(torch.isfinite(v)) and torch.all(torch.isfinite(g))):
        raise AssertionError(f"{what}: non-finite values")


def phase_train_bench(X, y, hyps):
    """bench.py's workload through the port's entry points."""
    import scipy.optimize

    from gpyreg_tpu_torch.ops import tile_kernels as TK

    gp = _se_gp(D_TR, np.float32)
    gp.update(X_new=X, y_new=y, hyp=hyps, compute_posterior=False)
    fns, args = gp._obj_args()
    nlz_grad = fns["nlz_grad"]
    width = D_TR + 3

    v, g = nlz_grad(hyps, *args)  # warm-up
    torch.cuda.synchronize()
    _check_finite(v, g, B_TR, width, "training warm-up")

    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    rates = []
    for r in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(ITERS):
            v, g = nlz_grad(hyps + 1e-4 * (r * ITERS + i), *args)
        torch.cuda.synchronize()
        rates.append(B_TR * ITERS / (time.perf_counter() - t0))
    launches = dict(TK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check_finite(v, g, B_TR, width, "training")
    evals = float(np.median(rates))
    print(f"training (bench.py workload): N={N_TR} D={D_TR} B={B_TR} float32; "
          f"NLML+grad median {evals:.2f} evals/s over {ROUNDS} rounds of "
          f"{ITERS} iterations (rounds {[round(x, 3) for x in rates]}); peak "
          f"device memory {peak / 2**30:.3f} GiB; launches {launches}")
    calls = B_TR * ROUNDS * ITERS
    none = dict.fromkeys(TK.LAUNCHES, 0)
    if launches != {**none, "self": calls, "vjp": calls}:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{calls} self and {calls} vjp")

    # The GP's own surface: one launch of each kernel per call.
    h0 = hyps[0]
    TK.reset_launches()
    ll, dll = gp.log_likelihood(h0, compute_grad=True)
    after_ll = dict(TK.LAUNCHES)
    gp.set_priors({name: ("gaussian", (0.0, 2.0))
                   for name, _ in gp._hyper_info()})
    lp, dlp = gp.log_posterior(h0, compute_grad=True)
    after_lp = dict(TK.LAUNCHES)
    lprior, dlprior = gp._GP__compute_log_priors(h0, True)
    print(f"GP.log_likelihood {ll:.6f} (launches {after_ll}); "
          f"GP.log_posterior {lp:.6f} = log_likelihood + log prior "
          f"{ll + lprior:.6f} (launches {after_lp})")
    if (after_ll != {**none, "self": 1, "vjp": 1}
            or after_lp != {**none, "self": 2, "vjp": 2}):
        raise AssertionError("log_likelihood / log_posterior did not launch "
                             "one of each kernel per call")
    if not (abs(lp - (ll + lprior)) <= 1e-6 * max(1.0, abs(lp))
            and np.max(np.abs(dlp - (dll + dlprior)))
            <= 1e-6 * max(1.0, float(np.max(np.abs(dlp))))):
        raise AssertionError("log_posterior is not log_likelihood + log prior")
    gp.set_priors(None)

    # A trainer: L-BFGS-B on the NLML from lane 0.
    def nlml(h):
        v, dv = gp.log_likelihood(h, compute_grad=True)
        return -v, -dv

    start_nlml = nlml(h0)[0]
    TK.reset_launches()
    t0 = time.perf_counter()
    res = scipy.optimize.minimize(nlml, h0, jac=True, method="L-BFGS-B",
                                  options={"maxiter": LBFGS_ITERS})
    secs = time.perf_counter() - t0
    lb_launches = dict(TK.LAUNCHES)
    print(f"L-BFGS-B: NLML {start_nlml:.4f} -> {res.fun:.4f} in {res.nit} "
          f"iterations, {res.nfev} evaluations, {secs / max(res.nit, 1):.4f} "
          f"s per iteration ({res.message}); launches {lb_launches}")
    if not (res.nit >= 1 and res.fun < start_nlml):
        raise AssertionError("L-BFGS-B did not lower the NLML")
    if lb_launches != {**none, "self": res.nfev, "vjp": res.nfev}:
        raise AssertionError("L-BFGS-B evaluations did not each launch one "
                             "of each kernel")
    return gp, {"evals_per_s": evals, "rounds": rates, "peak": peak,
                "launches": launches, "lbfgs": (start_nlml, float(res.fun),
                                                 res.nit, secs)}


def phase_train_config5(gp, hyp):
    """One batched NLML value and gradient over the serving GP's 8
    vectors at N = 16384, D = 10."""
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    fns, args = gp._obj_args()
    v, g = fns["nlz_grad"](hyp, *args)  # warm-up at this size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    t0 = time.perf_counter()
    v, g = fns["nlz_grad"](hyp, *args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check_finite(v, g, S, D + 3, "config-5 training")
    print(f"training at config 5: N={N} D={D} {S} lanes float32; "
          f"{secs / S:.4f} s per lane-eval ({secs:.3f} s the batch); peak "
          f"device memory {peak / 2**30:.2f} GiB (the serving factors "
          f"included); launches {launches}")
    if launches != {**dict.fromkeys(TK.LAUNCHES, 0), "self": S, "vjp": S}:
        raise AssertionError(f"config-5 training launches {launches}")
    return {"secs_per_lane": secs / S, "peak": peak, "launches": launches}


def _synced(fn):
    """(fn(), its seconds, the launches it made), the counts set to 0
    before and the card synchronised on both sides."""
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    torch.cuda.synchronize()
    TK.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(TK.LAUNCHES)


def _route(fn):
    """The routes of ``ops.linalg.robust_cholesky`` that an untimed call
    of ``fn`` took, read from its spans under the host profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    names = {e.name for e in prof.events()}
    return "+".join(k for k in ("cholesky", "eigh")
                    if f"gpyreg.robust_cholesky.{k}" in names)


def _expect(what, launches, **want):
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    want = {**dict.fromkeys(TK.LAUNCHES, 0), **want}
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


def phase_serving_rest(gp, X, y, xs, hyp):
    """Phase 9a on the config-5 serving GP, with the checks of the module
    docstring.  Returns the launches of each call, for the kernels line."""
    import warnings

    import scipy.stats  # noqa: F401 (its first import is not the phase's)

    from gpyreg_tpu_torch.convert import gp_from_arrays
    from gpyreg_tpu_torch.inference import map_optimize as MO

    t_phase = time.perf_counter()
    out = {}
    sf2_max = float(np.exp(2 * hyp[:, D].max()))
    # (a) Single-point updates.
    Xn, yn = _new_rows(R1_ROWS, SEED + 7)
    mu_old, _ = gp.predict(Xn, separate_samples=True)
    r1_ms, out["rank1"] = [], []
    for k in range(R1_ROWS):
        torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, secs, launches = _synced(
                lambda: gp.update(X_new=Xn[k : k + 1], y_new=yn[k : k + 1]))
        peak = torch.cuda.max_memory_allocated()
        rebuilt = sum("Rank-one posterior update unstable" in str(w.message)
                      for w in caught)
        r1_ms.append(secs * 1e3)
        out["rank1"].append(launches)
        print(f"serving_rest rank-1 update {k + 1}: N {N + k} -> {N + k + 1}, "
              f"{secs * 1e3:.3f} ms; unstable samples rebuilt {rebuilt}; peak "
              f"device memory {peak / 2**30:.2f} GiB; launches {launches}")
        _expect(f"rank-1 update {k + 1}", launches, cross_unaligned=S)
        if rebuilt or gp.posteriors[0].L.shape != (N + k + 1, N + k + 1):
            raise AssertionError(f"rank-1 update {k + 1}: {rebuilt} samples "
                                 f"fell back to a rebuild")
    X_all, y_all = np.concatenate([X, Xn]), np.concatenate([y, yn])
    sub = xs[:M_Q]
    (mu_r1, s2_r1), _, out["predict"] = _synced(
        lambda: gp.predict(sub, separate_samples=True))
    _expect(f"predict at {M_Q} points", out["predict"], cross=S)
    gp_rb, rb_s, _ = _synced(lambda: gp_from_arrays(
        _se_meta(D, "float32"), X_all, y_all, None, hyp, DEV))
    mu_rb, s2_rb = gp_rb.predict(sub, separate_samples=True)
    # Where the updates matter: the new rows themselves, each sample's
    # alpha and the last R1_ROWS columns of its factor.
    mu_r1n, s2_r1n = gp.predict(Xn, separate_samples=True)
    mu_rbn, s2_rbn = gp_rb.predict(Xn, separate_samples=True)
    fac = []
    for p, q in zip(gp.posteriors, gp_rb.posteriors):
        if p.L_chol != q.L_chol:
            raise AssertionError("rank-1: a sample changed parametrization")
        La, Lb = p.L[:, -R1_ROWS:], q.L[:, -R1_ROWS:]
        fac.append(tuple(torch.max(t).item() for t in (
            torch.abs(p.alpha - q.alpha), torch.abs(q.alpha),
            torch.abs(La - Lb), torch.abs(Lb))))
    del gp_rb, p, q, La, Lb
    torch.cuda.empty_cache()
    kappas = _kappa_bounds(X_all, hyp)
    rel = max(1e-4, 10.0 * max(kappas) * EPS32)
    err_mu = float(np.max(np.abs(mu_r1 - mu_rb)))
    err_s2 = float(np.max(np.abs(s2_r1 - s2_rb)))
    tol_mu = rel * max(1.0, float(np.max(np.abs(mu_rb))))
    err_mun = float(np.max(np.abs(mu_r1n - mu_rbn)))
    err_s2n = float(np.max(np.abs(s2_r1n - s2_rbn)))
    tol_mun = rel * max(1.0, float(np.max(np.abs(mu_rbn))))
    moved = float(np.max(np.abs(mu_old - mu_rbn)))
    print(f"serving_rest rank-1 at the {R1_ROWS} new rows: max|dmu|="
          f"{err_mun:.3e} (tol {tol_mun:.3e}), max|ds2|={err_s2n:.3e} (tol "
          f"{rel * sf2_max:.3e}); the updates moved mu there by up to "
          f"{moved:.3e}")
    bad = not (err_mun < tol_mun and err_s2n < rel * sf2_max)
    for s, (e_a, a_max, e_L, L_max) in enumerate(fac):
        rel_s = max(1e-4, 10.0 * kappas[s] * EPS32)
        print(f"  sample {s}: kappa(G) <= {kappas[s]:.1f}, tol {rel_s:.3e} "
              f"relative; alpha max|d|={e_a:.3e} (max|alpha| {a_max:.3e}), "
              f"last {R1_ROWS} columns of L max|d|={e_L:.3e} (max|L| "
              f"{L_max:.3e})")
        bad |= not (e_a < rel_s * max(1.0, a_max)
                    and e_L < rel_s * max(1.0, L_max))
    if bad:
        raise AssertionError("rank-1 factors or the new rows' predictions "
                             "disagree with the rebuild")
    print(f"serving_rest rank-1: {R1_ROWS} updates, {np.mean(r1_ms):.3f} ms "
          f"each (runs {r1_ms}) against a float32 full rebuild of the "
          f"{N + R1_ROWS} rows in {rb_s:.3f} s; predict at {M_Q} points, "
          f"{S} samples: max|dmu|={err_mu:.3e} (tol {tol_mu:.3e}), "
          f"max|ds2|={err_s2:.3e} (tol {rel * sf2_max:.3e}); kappa(G) <= "
          f"{max(kappas):.1f}, tol = max(1e-4, 10*kappa*eps32) relative")
    if not (err_mu < tol_mu and err_s2 < rel * sf2_max):
        raise AssertionError("rank-1 updates disagree with the rebuild")
    out["rank1_ms"], out["rebuild_s"] = r1_ms, rb_s

    # (b) predict_full at 1024 points.
    xp = xs[:M_PF]
    (mu_pf, cov_pf), pf_s, out["predict_full"] = _synced(
        lambda: gp.predict_full(xp))
    _expect("predict_full", out["predict_full"], self=S, cross=S)
    mu_g, s2_g = gp._group_predict(xp)
    diag = np.einsum("iis->is", cov_pf)
    err_d = float(np.max(np.abs(diag - s2_g))) / sf2_max
    err_m = float(np.max(np.abs(mu_pf - mu_g)))
    symmetric = bool(np.array_equal(cov_pf, cov_pf.transpose(1, 0, 2)))
    sub = xp[:: M_PF // M_FULL][:M_FULL]
    gp64 = gp_from_arrays(_se_meta(D, "float64"), X_all, y_all, None,
                          hyp[:S_FULL], DEV)
    mu64, cov64 = gp64.predict_full(sub)
    mu32, cov32 = gp.predict_full(sub)
    rel2 = 10.0 * max(kappas[:S_FULL]) * EPS32
    sf2_2 = float(np.exp(2 * hyp[:S_FULL, D].max()))
    e_mu = float(np.max(np.abs(mu32[:, :S_FULL] - mu64)))
    e_cov = float(np.max(np.abs(cov32[:, :, :S_FULL] - cov64)))
    t_mu = rel2 * max(1.0, float(np.max(np.abs(mu64))))
    print(f"serving_rest predict_full: M={M_PF} {pf_s:.3f} s; launches "
          f"{out['predict_full']}; symmetric {symmetric}; diagonal vs "
          f"_group_predict's raw variance max|d|/sf2={err_d:.3e} (tol 1e-4), "
          f"mean max|d|={err_m:.3e}; {S_FULL} samples at {M_FULL} points vs "
          f"float64 on the card: max|dmu|={e_mu:.3e} (tol {t_mu:.3e}), "
          f"max|dcov|={e_cov:.3e} (tol {rel2 * sf2_2:.3e})")
    if not (symmetric and err_d <= 1e-4 and err_m <= 1e-4 * max(
            1.0, float(np.max(np.abs(mu_g))))):
        raise AssertionError("predict_full disagrees with _group_predict")
    if not (e_mu < t_mu and e_cov < rel2 * sf2_2):
        raise AssertionError("predict_full disagrees with float64")
    out["predict_full_s"] = pf_s

    # (c) quad over 64 measures.
    mq = xs[:M_QUAD]
    (F, J), q_s, launches = _synced(
        lambda: gp.quad(mq, 0.5, compute_var=True, separate_samples=True))
    _expect("quad", launches)
    F64, J64 = gp64.quad(mq, 0.5, compute_var=True, separate_samples=True)
    del gp64
    torch.cuda.empty_cache()
    e_F = float(np.max(np.abs(F[:, :S_FULL] - F64)))
    e_J = float(np.max(np.abs(J[:, :S_FULL] - J64)))
    t_F = rel2 * max(1.0, float(np.max(np.abs(F64))))
    print(f"serving_rest quad: {M_QUAD} measures, sigma 0.5, compute_var, "
          f"separate_samples: {q_s * 1e3:.3f} ms; launches none; {S_FULL} "
          f"samples vs float64: max|dF|={e_F:.3e} (tol {t_F:.3e}), "
          f"max|dJ|={e_J:.3e} (tol {rel2 * sf2_2:.3e})")
    if not (F.shape == J.shape == (M_QUAD, S) and np.all(np.isfinite(F))
            and np.all(np.isfinite(J)) and e_F < t_F and e_J < rel2 * sf2_2):
        raise AssertionError("quad disagrees with float64")
    out["quad_ms"] = q_s * 1e3

    # (d) random_function: one draw at 1024 points, then 256 at 64.
    f1, rf_s, out["random_function"] = _synced(lambda: gp.random_function(xp))
    route = _route(lambda: gp.random_function(xp))
    _expect("random_function", out["random_function"], self=1, cross=1)
    if not (f1.shape == (M_PF, 1) and np.all(np.isfinite(f1))):
        raise AssertionError("random_function: not finite")
    xr = xs[:M_RF]
    np.random.seed(SEED)
    draws, rfn_s, out["random_draws"] = _synced(lambda: np.stack(
        [gp.random_function(xr)[:, 0] for _ in range(N_RF)]))
    _expect("random_function draws", out["random_draws"], self=N_RF,
            cross=N_RF)
    used = _route(lambda: gp.random_function(xr))
    mu_mix, s2_mix = gp.predict(xr)
    z = np.abs(draws.mean(axis=0) - mu_mix[:, 0]) / np.sqrt(s2_mix[:, 0] / N_RF)
    print(f"serving_rest random_function: one draw at {M_PF} points "
          f"{rf_s * 1e3:.3f} ms ({route} route); {N_RF} draws at {M_RF} "
          f"points {rfn_s:.3f} s ({rfn_s / N_RF * 1e3:.3f} ms a draw, "
          f"{used} route); their mean vs predict's mixture mean: max |d|/se = "
          f"{float(np.max(z)):.3f} (tol 5)")
    if not (np.all(np.isfinite(draws)) and np.all(z <= 5.0)):
        raise AssertionError("random_function draws miss the mixture mean")
    out["random_function_ms"] = rf_s * 1e3

    # (e) predict_quantile at 256 points.
    q, pq_s, out["predict_quantile"] = _synced(
        lambda: gp.predict_quantile([0.1, 0.5, 0.9], xs[:M_Q]))
    _expect("predict_quantile", out["predict_quantile"], cross=S)
    print(f"serving_rest predict_quantile: {M_Q} points, q = (0.1, 0.5, 0.9): "
          f"{pq_s * 1e3:.3f} ms; min gaps {np.min(np.diff(q, axis=1), axis=0)}")
    if not (q.shape == (M_Q, 3) and np.all(np.isfinite(q))
            and np.all(np.diff(q, axis=1) > 0)):
        raise AssertionError("predict_quantile: not finite and increasing")

    # (f) fmin with 3 starts, its objective's evaluations counted.
    evals = [0]
    inner = MO.multistart_map

    def counted(obj, starts, *a, **kw):
        def o(x):
            evals[0] += 1
            return obj(x)
        return inner(o, starts, *a, **kw)

    MO.multistart_map = counted
    try:
        np.random.seed(SEED)
        (x, fval), fm_s, launches = _synced(lambda: gp.fmin(n_starts=3))
    finally:
        MO.multistart_map = inner
    diam = X_all.max(axis=0) - X_all.min(axis=0)
    lb, ub = X_all.min(axis=0) - 10 * diam, X_all.max(axis=0) + 10 * diam
    best, _ = gp.predict(X_all[np.argmin(y_all.ravel())][None, :])
    print(f"serving_rest fmin: 3 starts, {fm_s:.3f} s, {evals[0]} objective "
          f"evaluations ({fm_s / evals[0] * 1e3:.3f} ms each); launches "
          f"{launches} (the plain composition); fval {fval:.6f}, mixture "
          f"mean at the best training row {float(best[0, 0]):.6f}")
    _expect("fmin", launches)
    if not (np.all(x >= lb) and np.all(x <= ub) and fval <= float(
            best[0, 0]) + 1e-6 * max(1.0, abs(fval))):
        raise AssertionError("fmin: out of its box or above its start")
    out["fmin_s"], out["fmin_evals"] = fm_s, evals[0]
    print(f"serving_rest: the phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def _grad_check(what, v32, g32, v64, g64, kappas):
    """Per lane and entry |dg| <= max(1e-3, 10 kappa eps32) max(|g64|, 1);
    the values at the same relative bound, scaled by max(|v64|, 1)."""
    g32, g64 = g32.double().cpu(), g64.double().cpu()
    v32, v64 = v32.double().cpu(), v64.double().cpu()
    worst = 0.0
    for s, kappa in enumerate(kappas):
        rel = max(1e-3, 10.0 * kappa * EPS32)
        err_g = torch.max(torch.abs(g32[s] - g64[s])
                          / torch.clamp(torch.abs(g64[s]), min=1.0)).item()
        err_v = abs(v32[s] - v64[s]).item() / max(1.0, abs(v64[s]).item())
        worst = max(worst, err_g / rel)
        print(f"  {what} lane {s}: kappa(G)={kappa:.1f} tol {rel:.3e}; "
              f"gradient max |dg|/max(|g64|,1)={err_g:.3e}, NLML "
              f"|dv|/max(|v64|,1)={err_v:.3e}")
        if not (err_g <= rel and err_v <= rel):
            raise AssertionError(f"{what} lane {s}: gradient or NLML outside "
                                 f"its tolerance")
    return worst


def phase_grad_accuracy(gp_bench, X_tr, y_tr, hyps_tr):
    # N = 2048: float32 on the card against float64 on the CPU.
    X, y, hyps = _train_data(N_GACC, SEED + 1)
    gp32 = _se_gp(D_TR, np.float32)
    gp64 = _se_gp(D_TR, np.float64, device="cpu")
    out = []
    for gp in (gp32, gp64):
        gp.update(X_new=X, y_new=y, hyp=hyps, compute_posterior=False)
        fns, args = gp._obj_args()
        out.append(fns["nlz_grad"](hyps, *args))
    Xc = torch.as_tensor(X)
    kappas = [_kappa(Xc, h) for h in hyps]
    print(f"gradient accuracy: N={N_GACC} D={D_TR} {B_TR} lanes, float32 "
          f"card vs float64 CPU")
    w1 = _grad_check(f"N={N_GACC}", *out[0], *out[1], kappas)

    # N = 4096: 2 lanes against a float64 build on the card.
    gp64 = _se_gp(D_TR, np.float64)
    gp64.update(X_new=X_tr, y_new=y_tr, hyp=hyps_tr[:S_GACC_FULL],
                compute_posterior=False)
    fns, args = gp64._obj_args()
    v64, g64 = fns["nlz_grad"](hyps_tr[:S_GACC_FULL], *args)
    fns, args = gp_bench._obj_args()
    v32, g32 = fns["nlz_grad"](hyps_tr[:S_GACC_FULL], *args)
    Xd = torch.as_tensor(X_tr, device=DEV)
    kappas = [_kappa(Xd, h) for h in hyps_tr[:S_GACC_FULL]]
    print(f"gradient accuracy: N={N_TR} D={D_TR} {S_GACC_FULL} lanes, "
          f"float32 vs float64 on the card")
    w2 = _grad_check(f"N={N_TR}", v32, g32, v64, g64, kappas)
    return max(w1, w2)


def _fit_data(n, d, seed):
    """A smooth function of X plus noise of standard deviation FIT_NOISE,
    above the float32 noise floor at both sizes, so that the MAP lies
    inside the bounds."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sum(np.sin(X), axis=1, keepdims=True) + FIT_NOISE * rng.normal(
        size=(n, 1))
    return X, y


def phase_fit_warm():
    """The first fit of the process, at a small size."""
    X, y = _fit_data(256, D_TR, SEED + 4)
    gp = _se_gp(D_TR, np.float32)
    np.random.seed(SEED)
    t0 = time.perf_counter()
    gp.fit(X, y, options={"n_samples": 0, "init_N": 8, "opts_N": 1})
    torch.cuda.synchronize()
    print(f"fit_warm: the first fit of the process, N=256 D={D_TR}, 8 design "
          f"rows, 1 restart: {time.perf_counter() - t0:.3f} s "
          f"({gp.fit_timings})")


def phase_fit(name, n, d, options, compare_float64):
    """``GP.fit`` without sampling on the card, with the checks of the
    module docstring.  Returns the launches of the fit and its timings."""
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    X, y = _fit_data(n, d, SEED + 3)
    gp = _se_gp(d, np.float32)
    init_N = options.get("init_N", 1024)
    tol = options.get("tol_opt", 1e-5)
    np.random.seed(SEED)  # the design's column permutation
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    t0 = time.perf_counter()
    hyp, res, samples = gp.fit(X, y, options=dict(options))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    restarts = gp.fit_report["restarts"]
    design_best = gp.fit_report["design_best"]
    tm = gp.fit_timings
    print(f"{name}: N={n} D={d} float32, options {options}: {wall:.3f} s = "
          f"design {tm['design_s']:.3f} s ({init_N} rows, "
          f"{tm['design_s'] / init_N * 1e3:.2f} ms a row) + optimize "
          f"{tm['optimize_s']:.3f} s ({launches['vjp']} value-and-gradient "
          f"evaluations, {tm['optimize_s'] / max(launches['vjp'], 1):.4f} s "
          f"each) + posterior {tm['posterior_s']:.3f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    for i, r in enumerate(restarts):
        print(f"  restart {i}: nit {r.nit}, objective {r.fun:.6f}, stopped on "
              f"{r.stop}, |grad_z|_inf {r.grad_norm:.3e}")
    print(f"  best design value {design_best:.6f} -> MAP objective "
          f"{res.fun:.6f}; MAP hyp {np.round(hyp[0], 4).tolist()}")

    if samples is not None or hyp.shape != (1, d + 3):
        raise AssertionError(f"{name}: fit returned {hyp.shape}, {samples}")
    if not (np.isfinite(res.fun) and res.fun < design_best):
        raise AssertionError(f"{name}: MAP objective {res.fun} is not below "
                             f"the best design value {design_best}")
    if not (res.stop == "objective_drop" or res.grad_norm < 100 * tol):
        raise AssertionError(
            f"{name}: the returned restart stopped on {res.stop} with "
            f"gradient inf-norm {res.grad_norm}")
    cov_N = d + 1
    LB = gp._f32_noise_floor(gp.lower_bounds, gp.upper_bounds, cov_N, options)
    print(f"  noise floor: log sigma_n >= {LB[cov_N]:.4f} (the GP's own lower "
          f"bound {gp.lower_bounds[cov_N]:.4f}); MAP log sigma_n "
          f"{hyp[0, cov_N]:.4f}")
    if not (LB[cov_N] > gp.lower_bounds[cov_N]
            and all(r.x[cov_N] >= LB[cov_N] for r in restarts)):
        raise AssertionError(f"{name}: the float32 noise floor did not hold")
    nit = sum(r.nit for r in restarts)
    if not (launches["vjp"] >= nit
            and launches["self"] >= init_N + launches["vjp"]
            and not any(v for k, v in launches.items()
                        if k.endswith("_unaligned"))
            and launches["cross"] == 0):
        raise AssertionError(f"{name}: launches {launches} for {nit} "
                             f"iterations and {init_N} design rows")
    a = gp.posteriors[0].alpha
    if not (tuple(a.shape) == (n, 1) and bool(torch.all(torch.isfinite(a)))):
        raise AssertionError(f"{name}: the posterior at the MAP is not finite")

    if compare_float64:
        gp64 = _se_gp(d, np.float64)
        gp64.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=False)
        f64 = gp64._objective(hyp[0])
        f32 = gp._objective(hyp[0])
        kappa = _kappa(torch.as_tensor(X, device=DEV), hyp[0])
        rel = max(1e-3, 10.0 * kappa * EPS32)
        err = abs(f32 - f64) / max(abs(f64), 1.0)
        print(f"  float32 objective at the MAP {f32:.6f}, float64 {f64:.6f}: "
              f"|df|/max(|f64|,1)={err:.3e} (tol {rel:.3e}, kappa(G)="
              f"{kappa:.1f})")
        if not err <= rel:
            raise AssertionError(f"{name}: float32 MAP objective disagrees "
                                 f"with float64")
    return {"launches": launches, "timings": dict(tm), "wall": wall,
            "nit": [r.nit for r in restarts],
            "stop": [r.stop for r in restarts], "fun": res.fun, "hyp": hyp}


class _CountingStream:
    """A chain's random stream that counts the steps (MALA), iterations
    (HMC) or ensemble iterations it serves."""

    STEPS = ("langevin", "hamiltonian", "ensemble_iteration")

    def __init__(self, stream):
        self.stream, self.steps = stream, 0

    def __getattr__(self, name):
        attr = getattr(self.stream, name)
        if name not in self.STEPS:
            return attr

        def counted(*args):
            self.steps += 1
            return attr(*args)
        return counted


def _count_chain_windows():
    """Wrap the port's chain drivers so that each call records the
    launches made inside it (the chain's window), without resetting the
    counts; returns the list the windows are appended to.  The windows of
    the MALA, HMC and ensemble chains also hold ``calls``, the calls of
    the chain's density (value and gradient for MALA and HMC), ``steps``,
    the steps or iterations its stream served, and for the ensemble
    ``walkers``."""
    from gpyreg_tpu_torch.inference import device_slice as DS
    from gpyreg_tpu_torch.inference import ensemble_slice as ES
    from gpyreg_tpu_torch.inference import hmc as HMC
    from gpyreg_tpu_torch.inference import mala as MALA
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    windows = []

    def wrap(fn, count=False):
        def run(*args, **kw):
            calls = [0]
            if count:  # (log_f, x0, stream, ...)
                log_f, x0, stream = args[:3]

                def counted(x, *a):
                    calls[0] += 1
                    return log_f(x, *a)
                stream = _CountingStream(stream)
                args = (counted, x0, stream) + args[3:]
            torch.cuda.synchronize()
            before = dict(TK.LAUNCHES)
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            w = {k: TK.LAUNCHES[k] - before[k] for k in before}
            if count:
                w.update(calls=calls[0], steps=stream.steps)
                if np.ndim(out[1]) == 2:  # the ensemble's final walkers
                    w["walkers"] = out[1].shape[0]
            windows.append(w)
            return out
        return run

    DS.sample = wrap(DS.sample)
    DS.sample_chains = wrap(DS.sample_chains)
    for mod in (MALA, HMC, ES):
        mod.sample = wrap(mod.sample, count=True)
    return windows


def _sum_window(windows, start):
    keys = windows[start].keys() if len(windows) > start else ()
    return {k: sum(w[k] for w in windows[start:]) for k in keys}


def _check_samples(name, gp, X, y, options, hyp, sr, opt_res, launches, window,
                   n_dens, compare_float64):
    """The checks of the module docstring on one sampled fit whose chain
    made ``n_dens`` density calls."""
    d = X.shape[1]
    hyp_N = gp._hyp_N()
    s_N = options.get("n_samples", 10)
    LB = gp._f32_noise_floor(gp.lower_bounds, gp.upper_bounds, d + 1, options)
    if hyp.shape != (s_N, hyp_N):
        raise AssertionError(f"{name}: hyp has shape {hyp.shape}")
    if not (np.all(hyp >= LB) and np.all(hyp <= gp.upper_bounds)):
        raise AssertionError(f"{name}: samples outside the fit's bounds")
    fns, args = gp._obj_args()
    total = sr["f_vals"][:, 0] + sr["log_priors"]
    worst = 0.0
    for x, v in zip(sr["samples"], total):
        ref = float(fns["log_post_chain_raw"](x, *args))
        worst = max(worst, abs(v - ref) / max(1.0, abs(ref)))
    print(f"  f_vals + log_priors against log_post_chain_raw recomputed at "
          f"{len(total)} samples: max relative difference {worst:.3e}")
    if not worst <= 1e-5:
        raise AssertionError(f"{name}: chain values differ from the recomputed "
                             f"log posterior by {worst:.3e}")
    print(f"  chain window launches {window}: self {window['self']} against "
          f"{n_dens} densities, so {window['self'] - n_dens} jitter retries")
    if window["self"] < n_dens:
        raise AssertionError(f"{name}: {window['self']} self launches for "
                             f"{n_dens} densities")
    nit = sum(r.nit for r in gp.fit_report["restarts"])
    if not (launches["vjp"] >= nit and launches["cross"] == 0
            and not any(v for k, v in launches.items()
                        if k.endswith("_unaligned"))):
        raise AssertionError(f"{name}: launches {launches} for {nit} "
                             f"iterations")
    if opt_res is not None and launches["vjp"] < 1:
        raise AssertionError(f"{name}: the MAP ran no gradient tile")
    if not all(bool(torch.all(torch.isfinite(p.alpha))) for p in gp.posteriors):
        raise AssertionError(f"{name}: a posterior's alpha is not finite")
    if compare_float64:
        gp64 = _se_gp(d, np.float64)
        gp64.update(X_new=X, y_new=y, hyp=hyp[:2], compute_posterior=False)
        Xd = torch.as_tensor(X, device=DEV)
        for h in hyp[:2]:
            f64 = -gp64._objective(h)
            f32 = -gp._objective(h)
            kappa = _kappa(Xd, h)
            rel = max(1e-3, 10.0 * kappa * EPS32)
            err = abs(f32 - f64) / max(abs(f64), 1.0)
            print(f"  float32 log posterior {f32:.6f}, float64 {f64:.6f}: "
                  f"|d|/max(|f64|,1)={err:.3e} (tol {rel:.3e}, kappa(G)="
                  f"{kappa:.1f})")
            if not err <= rel:
                raise AssertionError(f"{name}: float32 log posterior at a "
                                     f"sample disagrees with float64")
        del gp64


def phase_fit_sample(name, n, d, options, windows, gp=None, data=None,
                     compare_float64=False):
    """``GP.fit`` with hyperposterior sampling on the card (a new GP on
    ``_fit_data`` unless ``gp`` and ``data`` are given), with the checks
    of the module docstring.  Returns the GP, its data and the numbers of
    the phase."""
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    X, y = _fit_data(n, d, SEED + 3) if data is None else data
    gp = _se_gp(d, np.float32) if gp is None else gp
    np.random.seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    start = len(windows)
    t0 = time.perf_counter()
    hyp, res, sr = gp.fit(X, y, options=dict(options))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    window = _sum_window(windows, start)
    tm = gp.fit_timings
    # A coordinate-wise sweep makes one move per free dimension, a
    # random-direction sweep one move.
    if options.get("sampler") == "covsample":
        moves = 1
    else:
        moves = int(np.sum(gp.lower_bounds != gp.upper_bounds))
    sweeps = int(np.sum(sr["n_sweeps"]))
    n_evals = int(np.sum(sr["n_evals"]))
    R = sr.get("R")
    eff = sr.get("eff_N")
    print(f"{name}: N={X.shape[0]} D={d} float32, options {options}: "
          f"{wall:.3f} s = design {tm['design_s']:.3f} + optimize "
          f"{tm['optimize_s']:.3f} + sample {tm['sample_s']:.3f} + posterior "
          f"{tm['posterior_s']:.3f} s; peak device memory {peak / 2**30:.2f} "
          f"GiB; launches {launches}")
    print(f"  sample_s {tm['sample_s']:.3f} s, n_evals {n_evals} "
          f"(per chain {np.atleast_1d(sr['n_evals']).tolist()}), "
          f"{tm['sample_s'] / n_evals * 1e3:.3f} ms a density, "
          f"{n_evals / (sweeps * moves):.2f} densities a move ({sweeps} sweeps x "
          f"{moves} moves), {n_evals / tm['sample_s']:.1f} densities/s")
    print(f"  exit_flag {sr['exit_flag']}, max R "
          f"{'n/a' if R is None else f'{float(np.max(R)):.3f}'}, min eff_N "
          f"{'n/a' if eff is None else f'{float(np.min(eff)):.2f}'}, "
          f"post-burn widths "
          f"{np.round(sr['widths'], 5).tolist() if 'widths' in sr else 'n/a'}"
          f"{', ess_frac %.4f, thin_eff %d' % (sr['ess_frac'], sr['thin_eff']) if 'ess_frac' in sr else ''}")
    if res is not None:
        print(f"  MAP objective {res.fun:.6f} after "
              f"{[r.nit for r in gp.fit_report['restarts']]} iterations "
              f"({[r.stop for r in gp.fit_report['restarts']]})")
    _check_samples(name, gp, X, y, options, hyp, sr, res, launches, window,
                   n_evals, compare_float64)
    return gp, (X, y), {"launches": launches, "timings": dict(tm), "wall": wall,
                        "n_evals": n_evals, "peak": peak, "window": window,
                        "sr": sr, "res": res}


def phase_fit_mala_hmc_ensemble(name, n, d, options, windows,
                                grad_check=False):
    """``GP.fit`` with the sampler "mala", "hmc" or "eissample" on the card
    (on ``_fit_data``), with the checks of the module docstring.  Returns
    the numbers of the phase."""
    from gpyreg_tpu_torch.core.nlml import value_and_grad
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    X, y = _fit_data(n, d, SEED + 3)
    gp = _se_gp(d, np.float32)
    sampler = options["sampler"]
    np.random.seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    start = len(windows)
    t0 = time.perf_counter()
    hyp, res, sr = gp.fit(X, y, options=dict(options))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    window = _sum_window(windows, start)
    tm = gp.fit_timings
    calls, steps = window["calls"], window["steps"]
    ms_call = tm["sample_s"] / calls * 1e3
    if sampler == "eissample":
        moves = steps * window["walkers"]
        per = (f"{steps} iterations x {window['walkers']} walkers = {moves} "
               f"walker moves, {tm['sample_s'] / moves * 1e3:.3f} ms a walker "
               f"move, {calls / moves:.2f} densities a move; {calls} "
               f"densities, {ms_call:.3f} ms a density")
        accept = "n/a"
    else:
        unit = "step" if sampler == "mala" else "iteration"
        per = (f"{steps} {unit}s, {tm['sample_s'] / steps * 1e3:.3f} ms "
               f"{'a step' if unit == 'step' else 'an iteration'}; {calls} "
               f"value-and-gradient calls, {ms_call:.3f} ms a call")
        accept = f"{sr['accept_rate']:.4f}"
    R, eff = sr["R"], sr["eff_N"]
    print(f"{name}: N={n} D={d} float32, options {options}: {wall:.3f} s = "
          f"design {tm['design_s']:.3f} + optimize {tm['optimize_s']:.3f} + "
          f"sample {tm['sample_s']:.3f} + posterior {tm['posterior_s']:.3f} s; "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    print(f"  sample_s {tm['sample_s']:.3f} s: {per}; acceptance {accept}")
    print(f"  exit_flag {sr['exit_flag']}, max R "
          f"{'n/a' if R is None else f'{float(np.max(R)):.3f}'}, min eff_N "
          f"{'n/a' if eff is None else f'{float(np.min(eff)):.2f}'}")
    _check_samples(name, gp, X, y, options, hyp, sr, res, launches, window,
                   calls, compare_float64=False)
    # MALA and HMC: at least one gradient tile a value-and-gradient call;
    # the ensemble chain is value-only.
    value_only = sampler == "eissample"
    print(f"  chain window: vjp {window['vjp']} for {calls} "
          f"{'densities (value only)' if value_only else 'value-and-gradient calls'}")
    if window["vjp"] != 0 if value_only else window["vjp"] < calls:
        raise AssertionError(f"{name}: the chain launched the gradient tile "
                             f"{window['vjp']} times for {calls} calls")
    if grad_check:
        # The float32 value and gradient of log_post_raw at the last two
        # kept samples against a float64 build on the card.
        fns, args = gp._obj_args()
        v32, g32 = value_and_grad(lambda h: fns["log_post_raw"](h, *args),
                                  hyp[-2:], args[0])
        gp64 = _se_gp(d, np.float64)
        gp64.update(X_new=X, y_new=y, hyp=hyp[-2:], compute_posterior=False)
        fns, args = gp64._obj_args()
        v64, g64 = value_and_grad(lambda h: fns["log_post_raw"](h, *args),
                                  hyp[-2:], args[0])
        del gp64
        Xd = torch.as_tensor(X, device=DEV)
        kappas = [_kappa(Xd, h) for h in hyp[-2:]]
        print(f"  log_post_raw value and gradient at the last 2 kept samples, "
              f"float32 vs float64 on the card")
        _grad_check(f"{name} sample", v32, g32, v64, g64, kappas)
    return {"launches": launches, "window": window, "calls": calls}


def phase_refit_slicelite(gp, data, windows):
    """A slicelite fit on the fit_sample_bench GP after REFIT_ROWS more
    rows of the same function: it must take the warm-refit shortcut."""
    X, y = data
    rng = np.random.default_rng(SEED + 5)
    Xn = rng.normal(size=(REFIT_ROWS, X.shape[1]))
    yn = np.sum(np.sin(Xn), axis=1, keepdims=True) + FIT_NOISE * rng.normal(
        size=(REFIT_ROWS, 1))
    data = (np.vstack([X, Xn]), np.vstack([y, yn]))
    options = {"sampler": "slicelite"}
    gp, data, out = phase_fit_sample("refit_slicelite_bench", data[0].shape[0],
                                     X.shape[1], options, windows, gp=gp,
                                     data=data)
    sr = out["sr"]
    if out["res"] is not None or "ess_frac" not in sr or "thin_eff" not in sr:
        raise AssertionError(f"refit_slicelite_bench: the warm refit was not "
                             f"taken (ess_frac "
                             f"{getattr(gp, 'slicelite_ess_frac', None)})")
    return gp, out


def _se_meta(d, dtype):
    """``convert.gp_from_arrays``'s meta of ``_se_gp``."""
    return {"D": d, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0], "dtype": dtype}


def phase_gp_sample(gp5, data5, data_b, hyp_b, windows):
    """GP.sample on the config-5 GP (beta 0) and on the fit_sample_bench
    GP, rebuilt from its data and samples ``hyp_b`` (beta 0.5), with the
    checks of the module docstring."""
    from gpyreg_tpu_torch.convert import gp_from_arrays
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    gp_b = gp_from_arrays(_se_meta(hyp_b.shape[1] - 3, "float32"), *data_b,
                          None, hyp_b, DEV)
    out = {}
    for label, g, n, beta in (("config5", gp5, GP_SAMPLE_N[0], 0.0),
                              ("bench", gp_b, GP_SAMPLE_N[1], 0.5)):
        S_g = g.posteriors.size
        torch.cuda.synchronize()
        TK.reset_launches()
        start = len(windows)
        t0 = time.perf_counter()
        samples = g.sample(n, beta=beta, key=SEED)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(TK.LAUNCHES)
        n_dens = launches["cross_unaligned"] // S_g
        X = g.X
        diam = X.max(axis=0) - X.min(axis=0)
        lb, ub = X.min(axis=0) - 10 * diam, X.max(axis=0) + 10 * diam
        print(f"gp_sample {label}: GP.sample({n}, beta={beta}) on N={X.shape[0]} "
              f"D={X.shape[1]}, {S_g} posteriors: {secs:.3f} s, {n_dens} "
              f"densities, {secs / n_dens * 1e3:.3f} ms a density; launches "
              f"{launches}")
        if not (samples.shape == (n, X.shape[1]) and np.all(np.isfinite(samples))
                and np.all(samples >= lb) and np.all(samples <= ub)):
            raise AssertionError(f"gp_sample {label}: samples not finite or "
                                 f"out of bounds")
        n_cross = launches["cross_unaligned"]
        if not (n_cross > 0 and n_cross % S_g == 0 and launches == {
                **dict.fromkeys(TK.LAUNCHES, 0), "cross_unaligned": n_cross}):
            raise AssertionError(f"gp_sample {label}: launches {launches}")
        out[label] = {"launches": launches, "secs": secs, "densities": n_dens,
                      "window": _sum_window(windows, start)}
    # At 3 samples of the config-5 chain, the density (beta 0: the float32
    # mixture mean) against the mixture mean of a float64 build's predict.
    X, y = data5
    hyp = gp5.get_hyperparameters(as_array=True)
    del gp_b
    gp64 = gp_from_arrays(_se_meta(X.shape[1], "float64"), X, y, None, hyp, DEV)
    pts = gp5.sample(3, key=SEED + 1)
    mu64, _ = gp64.predict(pts)
    del gp64
    torch.cuda.empty_cache()
    mean = gp5._mixture_mean_variance_fn(compute_var=False)
    worst = 0.0
    for x, m64 in zip(pts, mu64[:, 0]):
        m32 = float(mean(torch.tensor(x))[0])
        worst = max(worst, abs(m32 - m64) / max(1.0, abs(m64)))
    print(f"gp_sample: the float32 density at 3 samples against a float64 "
          f"mixture mean from predict: max |d|/max(|mu64|,1) = {worst:.3e} "
          f"(tol 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError("gp_sample: the density disagrees with float64")
    return out


def _cg_data():
    """benchmarks/matrix_free_sampling.py's data from one generator: part
    A's X, y and 512 held-out points at N_CG rows, then part B's X and y at
    N_CG_B rows, then (beyond the script) 512 held-out points for part B."""
    rng = np.random.default_rng(SEED)

    def rows(n):
        X = rng.normal(size=(n, D_CG))
        return X, np.sum(np.sin(X), axis=1, keepdims=True) + 0.1 * rng.normal(
            size=(n, 1))

    X, y = rows(N_CG)
    xs = rng.normal(size=(M_CG, D_CG))
    Xb, yb = rows(N_CG_B)
    xbs = rng.normal(size=(M_CG, D_CG))
    return X, y, xs, Xb, yb, xbs


def _count_matvecs():
    """Wrap ``ops.iterative._panel_matvec`` so that each call adds one to
    the returned counter; returns (counter, the unwrapped function)."""
    from gpyreg_tpu_torch.ops import iterative as IT

    plain, count = IT._panel_matvec, [0]

    def counted(*a, **kw):
        count[0] += 1
        return plain(*a, **kw)

    IT._panel_matvec = counted
    return count, plain


def _kappa_bound(X, h):
    """(lambda_max(K) + sn2) / sn2 >= cond(K + sn2 I) for an ARD-SE row
    ``h``, lambda_max from 50 steps of power iteration in float64 on the
    card, K built a row panel at a time."""
    from gpyreg_tpu_torch.ops.kernels import kernel_matrix

    Xd = torch.as_tensor(X, device=DEV)
    n, d = Xd.shape
    hc = torch.as_tensor(h[: d + 1], device=DEV)
    v = torch.ones((n, 1), dtype=Xd.dtype, device=DEV) / np.sqrt(n)
    for _ in range(50):
        w = torch.cat([kernel_matrix("se", hc, Xd[i : i + 4096], Z=Xd) @ v
                       for i in range(0, n, 4096)])
        lam = float(torch.linalg.norm(w))
        v = w / lam
    sn2 = float(np.exp(2 * h[d + 1]))
    return (lam + sn2) / sn2


def phase_cg_65536(data, mv):
    """The matrix-free tier at full width (module docstring, phase 23)."""
    import tempfile

    import gpyreg_tpu_torch as gt
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    X, y, xs = data[:3]
    count, plain_mv = mv
    panels = N_CG // CG_OPTS["cg_row_chunk"]
    gp = _se_gp(D_CG, np.float32)
    hyp0 = np.concatenate([np.full(D_CG, 0.5), [0.0], [-1.0], [0.0]])
    np.random.seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    count[0] = 0
    t0 = time.perf_counter()
    hyp, res, sr = gp.fit(X, y, hyp0=hyp0, options=dict(CG_OPTS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_launches, fit_mv = dict(TK.LAUNCHES), count[0]
    fit_peak = torch.cuda.max_memory_allocated()
    tm = gp.fit_timings
    iters = np.asarray(res.cg_iters)
    max_iter = CG_OPTS["cg_max_iter"]
    print(f"cg_65536: N={N_CG} D={D_CG} float32, fit(options={CG_OPTS}) "
          f"(cg_max_opt_iter cut from 40 to {CG_OPT_ITERS}): {wall:.3f} s = "
          f"design_s {tm['design_s']:.3f} ({CG_OPTS['cg_init_N']} rows) + "
          f"optimize_s {tm['optimize_s']:.3f} ({res.nfev} evaluations, "
          f"{res.nit} iterations, stop {res.message!r}) + posterior_s "
          f"{tm['posterior_s']:.3f}; method {gp._infer_method}; peak device "
          f"memory {fit_peak / 2**30:.3f} GiB; launches {fit_launches}, "
          f"{fit_mv} matvecs")
    print(f"  CG iterations per evaluation (res.cg_iters) {iters.tolist()}: "
          f"mean {iters.mean():.1f}, {int(np.sum(iters >= max_iter))} at "
          f"max_iter {max_iter}; MAP hyp {np.round(hyp[0], 4).tolist()}")
    if not (gp._infer_method == "cg" and sr is None and hyp.shape == (1, D_CG + 3)
            and all(p.matrix_free for p in gp.posteriors)):
        raise AssertionError("cg_65536: method 'auto' did not fit by CG")
    want = {**dict.fromkeys(TK.LAUNCHES, 0), "cross": panels * fit_mv}
    if fit_launches != want or fit_mv == 0:
        raise AssertionError(f"cg_65536: fit launches {fit_launches}, expected "
                             f"{want}: every panel of every matvec a tile")

    # One matvec of the fit's shape (1 + 8 probe columns) at the MAP.
    spec = gp._spec()
    Xd, yd, _ = gp._data()
    hc = gp._tensor(hyp[0, : D_CG + 1])
    V = torch.randn((N_CG, 1 + CG_OPTS["cg_n_probes"]), device=DEV)
    sn2 = torch.full((N_CG,), float(np.exp(2 * hyp[0, D_CG + 1])), device=DEV)
    with torch.no_grad():
        mv_ms = _time_ms(lambda: plain_mv(spec, hc, Xd, V, sn2,
                                          CG_OPTS["cg_row_chunk"]), 5)
    print(f"  ms per matvec (the fit's, {panels} panels of "
          f"{CG_OPTS['cg_row_chunk']}x{N_CG}, 9 columns): {mv_ms:.3f} ms")

    TK.reset_launches()
    count[0] = 0
    t0 = time.perf_counter()
    mu, s2 = gp.predict(xs)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    pred_launches, pred_mv = dict(TK.LAUNCHES), count[0]
    peak = torch.cuda.max_memory_allocated()
    rep = gp.cg_report[0]
    rmse = float(np.sqrt(np.mean((mu - np.sum(np.sin(xs), axis=1,
                                              keepdims=True)) ** 2)))
    print(f"  predict at {M_CG} points: {t_pred:.3f} s, {pred_mv} matvecs, "
          f"launches {pred_launches}; CG {rep} (max_iter {max_iter}"
          f"{', REACHED' if max(rep['alpha_iters'], rep['var_iters']) >= max_iter else ''}"
          f"); RMSE against the noise-free function {rmse:.4f} (noise sd 0.1); "
          f"peak device memory over fit and predict {peak / 2**30:.3f} GiB "
          f"(limit {CG_PEAK_BYTES / 2**30:.0f} GiB)")
    if mu.shape != (M_CG, 1) or s2.shape != (M_CG, 1) or not (
            np.all(np.isfinite(mu)) and np.all(np.isfinite(s2))):
        raise AssertionError("cg_65536: predict is not finite of shape (512, 1)")
    want = {**dict.fromkeys(TK.LAUNCHES, 0),
            "cross": panels * pred_mv + -(-M_CG // gp._cg_options["test_chunk"])}
    if pred_launches != want:
        raise AssertionError(f"cg_65536: predict launches {pred_launches}, "
                             f"expected {want}")
    if not peak < CG_PEAK_BYTES:
        raise AssertionError(f"cg_65536: peak {peak} bytes >= 8 GiB")

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "gpyreg_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "cg_65536.npz")
        gp.save(path)
        gp2 = gt.GP.load(path, device=DEV)
    t0 = time.perf_counter()
    mu2, s22 = gp2.predict(xs)
    t_pred2 = time.perf_counter() - t0
    same = np.array_equal(mu, mu2) and np.array_equal(s2, s22)
    print(f"  save/load: reloaded {gp2._infer_method} GP predicts in "
          f"{t_pred2:.3f} s, bit for bit the same: {same}")
    if not same:
        raise AssertionError("cg_65536: the reloaded GP predicts differently")
    return {"fit_launches": fit_launches, "fit_matvecs": fit_mv,
            "pred_launches": pred_launches, "pred_matvecs": pred_mv,
            "timings": dict(tm), "cg_iters": iters.tolist(), "mv_ms": mv_ms,
            "predict_s": t_pred, "peak": peak, "report": rep, "hyp": hyp[0]}


def _hutchinson_se(spec, h, Xd, yd, sol, key):
    """Per-entry standard error of the Hutchinson part of ``cg_nlml``'s
    gradient, from its P probes: the gradient of 0.5 u_i^T A(h) z_i for
    each probe i alone (``ops.iterative._surrogate_grad`` with alpha 0 and
    one probe; u_i from the solution block ``sol``), std over i / sqrt(P).
    The rows must fill whole panels (no padding)."""
    from gpyreg_tpu_torch.core.model import mean_value, noise_variance
    from gpyreg_tpu_torch.ops import iterative as IT

    n, P = Xd.shape[0], CG_EST["n_probes"]
    hyp = torch.as_tensor(h).to(dtype=Xd.dtype, device=Xd.device)
    Z = IT.make_probes(key, (n, P), Xd.dtype, Xd.device)

    def parts(hh):
        hc, hn, hm = spec.split_hyp(hh)
        sn2 = noise_variance(spec, hn, yd, None, Xd.dtype)
        return (hc, torch.broadcast_to(torch.reshape(sn2, (-1,)), (n,)),
                mean_value(spec, hm, Xd)[:, None])

    zero = torch.zeros_like(sol[:, :1])
    g = np.stack([
        IT._surrogate_grad(spec, hyp, Xd, yd, None, parts, CG_EST["row_chunk"],
                           zero, sol[:, 1 + i : 2 + i], Z[:, i : i + 1], 1)
        for i in range(P)])
    return np.std(g, axis=0, ddof=1) / np.sqrt(P)


def phase_cg_fidelity(data, mv):
    """The matrix-free tier against exact float64 at N_CG_B rows (module
    docstring, phase 24)."""
    from gpyreg_tpu_torch.ops import iterative as IT
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    Xb, yb, xbs = data[3:]
    count = mv[0]
    opts = {**CG_OPTS, "method": "cg"}
    gp = _se_gp(D_CG, np.float32)
    hyp0 = np.concatenate([np.full(D_CG, 0.3), [0.0], [-1.0], [0.0]])
    np.random.seed(SEED)
    TK.reset_launches()
    count[0] = 0
    t0 = time.perf_counter()
    hyp, res, _ = gp.fit(Xb, yb, hyp0=hyp0, options=opts)
    torch.cuda.synchronize()
    print(f"cg_fidelity_8192: N={N_CG_B} D={D_CG} fit(method 'cg', "
          f"cg_max_opt_iter {CG_OPT_ITERS}) {time.perf_counter() - t0:.3f} s, "
          f"timings {gp.fit_timings}, CG iterations {res.cg_iters.tolist()}, "
          f"launches {dict(TK.LAUNCHES)}, {count[0]} matvecs; MAP "
          f"{np.round(hyp[0], 4).tolist()}")
    fit_launches = dict(TK.LAUNCHES)
    h_map = hyp[0]
    spec = gp._spec()
    Xd, yd, _ = gp._data()
    gp64 = _se_gp(D_CG, np.float64)
    gp64.update(X_new=Xb, y_new=yb, hyp=hyp, compute_posterior=False)
    fns64, args64 = gp64._obj_args()

    # The estimator at the MAP and 4 perturbations, at the settings of
    # tests/test_iterative.py:233-264: the value within its 1% bound; the
    # gradient within 0.15 max(|g64|, 1), or, where the probes' own
    # sampling error is larger than that, within 4 standard errors of the
    # Hutchinson mean (_hutchinson_se) plus 1e-2 max(|g64|, 1).
    prng = np.random.default_rng(1)
    points = [h_map] + [h_map + 0.05 * prng.normal(size=h_map.shape)
                        for _ in range(4)]
    TK.reset_launches()
    count[0] = 0
    worst_v, worst_g, est_iters = 0.0, [], []
    t0 = time.perf_counter()
    for i, h in enumerate(points):
        est, g, sol, it = IT.cg_nlml(spec, h, Xd, yd, key=1, compute_grad=True,
                                     return_sol=True, **CG_EST)
        est_iters.append(it)
        v64, g64 = fns64["nlz_grad"](h, *args64)
        v64, g64 = float(v64), g64.cpu().numpy()
        scale = max(1.0, float(np.max(np.abs(g64))))
        err_v = abs(est - v64) / abs(v64)
        err = np.abs(g - g64)
        bound = np.full(err.shape, CG_EST_GRAD_TOL * scale)
        se = np.full(err.shape, np.nan)
        if np.any(err > bound):  # the probes' error, where it matters
            se = _hutchinson_se(spec, h, Xd, yd, sol, key=1)
            bound = np.maximum(bound, 4.0 * se + 1e-2 * scale)
        worst_v = max(worst_v, err_v)
        worst_g.append(float(np.max(err / bound)))
        print(f"  cg_nlml point {i}: {it} CG iterations; estimate {est:.4f}, "
              f"exact float64 {v64:.4f}: relative {err_v:.3e} (tol "
              f"{CG_EST_VALUE_TOL}); gradient max|dg|/max(|g64|,1) "
              f"{float(np.max(err)) / scale:.3e} (the test's bound "
              f"{CG_EST_GRAD_TOL}); |dg| {np.round(err, 3).tolist()}, "
              f"4 SE {np.round(4 * se, 3).tolist()}, g64 "
              f"{np.round(g64, 3).tolist()}; |dg| / bound "
              f"{worst_g[-1]:.3f}")
    est_s = time.perf_counter() - t0
    est_launches = dict(TK.LAUNCHES)
    print(f"  estimator ({CG_EST}): {est_s:.3f} s for 5 values, gradients and "
          f"standard errors with their float64 references; launches "
          f"{est_launches}, {count[0]} matvecs")
    if not (worst_v < CG_EST_VALUE_TOL and max(worst_g) <= 1.0):
        raise AssertionError("cg_fidelity: cg_nlml outside the estimator's "
                             "bounds")

    # cg_predict against the exact float64 predict at the MAP.
    gp64.update(hyp=hyp)
    mu64, s264 = gp64._group_predict(xbs)
    del gp64
    kappa = _kappa_bound(Xb, h_map)
    sf2 = float(np.exp(2 * h_map[D_CG]))
    pred = {}
    for rank in (0, CG_PRECOND_RANK):
        TK.reset_launches()
        count[0] = 0
        t0 = time.perf_counter()
        mu32, s232, info = IT.cg_predict(
            spec, gp._tensor(h_map), Xd, yd, None, gp._tensor(xbs),
            compute_var=True, tol=opts["cg_predict_tol"],
            row_chunk=opts["cg_row_chunk"], max_iter=opts["cg_max_iter"],
            precond_rank=rank)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        res_cg = max(info["alpha_rel_residual"], info["var_rel_residual"])
        rel = 10.0 * kappa * max(res_cg, EPS32)
        tol_mu = rel * max(1.0, float(np.max(np.abs(mu64))))
        tol_s2 = rel * sf2
        err_mu = float(np.max(np.abs(mu32 - mu64)))
        err_s2 = float(np.max(np.abs(s232 - np.maximum(s264, 0.0))))
        hit = max(info["alpha_iters"], info["var_iters"]) >= opts["cg_max_iter"]
        print(f"  cg_predict precond_rank {rank}: {secs:.3f} s, alpha "
              f"{info['alpha_iters']} iterations (relative residual "
              f"{info['alpha_rel_residual']:.3e}), variance "
              f"{info['var_iters']} iterations ({info['var_rel_residual']:.3e})"
              f"{', max_iter REACHED' if hit else ''}; launches "
              f"{dict(TK.LAUNCHES)}, {count[0]} matvecs; max|dmu| "
              f"{err_mu:.3e} (tol {tol_mu:.3e}), max|ds2| {err_s2:.3e} (tol "
              f"{tol_s2:.3e}); tol = 10 kappa max(residual, eps32), kappa(G) "
              f"<= {kappa:.1f}")
        if not (err_mu < tol_mu and err_s2 < tol_s2):
            raise AssertionError(f"cg_fidelity: cg_predict (rank {rank}) "
                                 f"disagrees with the exact float64 predict")
        pred[rank] = {"launches": dict(TK.LAUNCHES), "matvecs": count[0],
                      "s": secs, "info": {k: v for k, v in info.items()
                                          if k != "alpha"}}

    # The fixed-probe chain from the MAP, cut to CG_CHAIN's sweeps.
    chain_opts = {**opts, **CG_CHAIN, "cg_init_N": 1, "cg_max_opt_iter": 1}
    gp_c = _se_gp(D_CG, np.float32)
    np.random.seed(SEED)
    TK.reset_launches()
    count[0] = 0
    t0 = time.perf_counter()
    hyp_c, _, sr = gp_c.fit(Xb, yb, hyp0=h_map, options=chain_opts)
    torch.cuda.synchronize()
    chain_launches, chain_mv = dict(TK.LAUNCHES), count[0]
    log_f, _ = IT.cg_log_post_raw(
        spec, CG_CHAIN["cg_sample_tol"], opts["cg_row_chunk"],
        CG_CHAIN["cg_sample_max_iter"], opts["cg_n_probes"],
        opts["cg_n_lanczos"], False, False)
    worst = 0.0
    for x, fv, lp in zip(sr["samples"], sr["f_vals"][:, 0], sr["log_priors"]):
        ref = float(log_f(torch.as_tensor(x), Xd, yd, 0))
        worst = max(worst, abs(fv + lp - ref) / max(1.0, abs(ref)))
    print(f"  fixed-probe chain ({CG_CHAIN}, cut): {time.perf_counter() - t0:.3f} "
          f"s, timings {gp_c.fit_timings}, n_evals {sr.get('n_evals')}, "
          f"launches {chain_launches}, {chain_mv} matvecs; kept samples' "
          f"values against the recomputed frozen-probe log posterior: max "
          f"relative difference {worst:.3e}")
    if hyp_c.shape != (CG_CHAIN["n_samples"], D_CG + 3) or not worst <= 1e-6:
        raise AssertionError("cg_fidelity: the chain's values are not the "
                             "frozen-probe log posterior")
    return {"fit_launches": fit_launches, "est_launches": est_launches,
            "pred": pred, "chain_launches": chain_launches,
            "est_worst": (worst_v, max(worst_g)), "est_iters": est_iters}


def _ow_data(n, d, m, seed):
    """A log density with a heavy lower tail, -|x|^2 / 2 plus noise, at n
    rows and at m held-out points."""
    rng = np.random.default_rng(seed)

    def rows(k):
        X = rng.normal(size=(k, d))
        return X, -0.5 * np.sum(X**2, axis=1, keepdims=True) + 0.1 * rng.normal(
            size=(k, 1))

    return rows(n) + rows(m)


def phase_outwarp(windows):
    """Output warping at config 5's width and its sampled fit (module
    docstring, phase 25)."""
    import gpyreg_tpu_torch as gt
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    X, y, xs, ys = _ow_data(N, D, M_TEST, SEED + 8)
    gp = _se_gp(D, np.float32, outwarp=gt.outwarp_functions.NegativePowerC1())
    np.random.seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    t0 = time.perf_counter()
    hyp, res, _ = gp.fit(X, y, options=dict(OW_MAP))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_launches = dict(TK.LAUNCHES)
    nit = sum(r.nit for r in gp.fit_report["restarts"])
    hyp_N = gp._hyp_N()
    print(f"outwarp_config5: N={N} D={D} float32, NegativePowerC1, y in "
          f"[{y.min():.2f}, {y.max():.2f}], fit({OW_MAP}): {wall:.3f} s, "
          f"timings {gp.fit_timings}, restarts "
          f"{[(r.nit, round(r.fun, 4), r.stop) for r in gp.fit_report['restarts']]}"
          f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {fit_launches}; MAP {np.round(hyp[0], 4).tolist()} "
          f"(the last two: the warp's y0 and log k)")
    if not (hyp.shape == (1, hyp_N) and fit_launches["vjp"] >= nit
            and fit_launches["self"] >= OW_MAP["init_N"] + fit_launches["vjp"]
            and fit_launches["cross"] == 0
            and not any(v for k, v in fit_launches.items()
                        if k.endswith("_unaligned"))):
        raise AssertionError(f"outwarp_config5: fit launches {fit_launches} "
                             f"for {nit} iterations")

    TK.reset_launches()
    t0 = time.perf_counter()
    mu, s2, lpd = gp.predict(xs, ys, return_lpd=True)
    t_pred = time.perf_counter() - t0
    pred_launches = dict(TK.LAUNCHES)
    TK.reset_launches()
    t0 = time.perf_counter()
    q = gp.predict_quantile([0.1, 0.5, 0.9], xs[:M_Q])
    t_q = time.perf_counter() - t0
    q_launches = dict(TK.LAUNCHES)
    print(f"  predict at {M_TEST} points with return_lpd: {t_pred:.3f} s = "
          f"{M_TEST / t_pred:.1f} pts/s, mean lpd {float(np.mean(lpd)):.4f}, "
          f"launches {pred_launches}; predict_quantile at {M_Q} points "
          f"{t_q * 1e3:.1f} ms, launches {q_launches}")
    n_chunks = -(-M_TEST // gp._predict_chunk(N, M_TEST))
    if not (all(np.all(np.isfinite(a)) for a in (mu, s2, lpd))
            and mu.shape == s2.shape == lpd.shape == (M_TEST, 1)
            and q.shape == (M_Q, 3) and np.all(np.isfinite(q))
            and np.all(np.diff(q, axis=1) > 0)
            and pred_launches == {**dict.fromkeys(TK.LAUNCHES, 0),
                                  "cross": n_chunks}
            and q_launches == {**dict.fromkeys(TK.LAUNCHES, 0), "cross": 1}):
        raise AssertionError("outwarp_config5: predict or predict_quantile")

    # log_likelihood with its gradient, float32 against float64 on the card.
    gp64 = _se_gp(D, np.float64, outwarp=gt.outwarp_functions.NegativePowerC1())
    gp64.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=False)
    v64, g64 = gp64.log_likelihood(hyp[0], compute_grad=True)
    del gp64
    v32, g32 = gp.log_likelihood(hyp[0], compute_grad=True)
    kappa = _kappa_bound(X, hyp[0])
    print(f"  log_likelihood float32 vs float64 on the card at the MAP "
          f"(warp gradient {np.round(g32[-2:], 4).tolist()}):")
    _grad_check("outwarp", torch.tensor([v32]), torch.tensor(g32[None]),
                torch.tensor([v64]), torch.tensor(g64[None]), [kappa])
    torch.cuda.empty_cache()

    samp = phase_fit_sample(
        "outwarp_fit_sample_bench", N_TR, D_TR, dict(OW_SAMPLE), windows,
        gp=_se_gp(D_TR, np.float32,
                  outwarp=gt.outwarp_functions.NegativePowerC1()),
        data=_ow_data(N_TR, D_TR, 0, SEED + 9)[:2])[2]
    return {"fit_launches": fit_launches, "pred_launches": pred_launches,
            "q_launches": q_launches, "sample": samp, "timings": gp.fit_timings,
            "predict_s": t_pred}


def _smoke_mesh():
    """The mesh of the mesh group: the first 2 or 4 cards of a host with
    several (a power of two, so that every shard's shapes stay on the TMA
    paths), else 4 shards on the one card."""
    from gpyreg_tpu_torch.parallel.mesh import make_mesh

    count = torch.cuda.device_count()
    if count >= 2:
        P = 4 if count >= 4 else 2
        mesh = make_mesh(devices=[torch.device("cuda", i) for i in range(P)])
        how = f"{P} cards of {count}"
    else:
        mesh = make_mesh(devices=[torch.device("cuda", 0)] * MESH_SHARDS)
        how = f"{MESH_SHARDS} shards on the one card"
    print(f"mesh: {mesh} ({how})")
    if mesh.size < 2:
        raise AssertionError("mesh: fewer than 2 shards")
    return mesh


def _mesh_predict_chunks(mesh):
    """GP.predict's chunks of config 5's 100k test points on ``mesh``:
    (chunk, the full chunks of all shards, the ragged last chunks of all
    shards, the ragged chunk's width)."""
    from gpyreg_tpu_torch.gp import _PREDICT_CHUNK_ELEMS

    chunk = min(-(-M_TEST // mesh.size), _PREDICT_CHUNK_ELEMS // N)
    sizes = [b - a for a, b in mesh.slices(M_TEST)]
    tails = {n % chunk for n in sizes if n % chunk}
    if len(tails) > 1:
        raise AssertionError(f"mesh: shards of {sizes} points")
    return (chunk, sum(n // chunk for n in sizes),
            sum(1 for n in sizes if n % chunk), tails.pop() if tails else 0)


def _se_spec(d):
    from gpyreg_tpu_torch.core.model import ModelSpec

    return ModelSpec(D=d, cov="se", mean="const", noise_constant=True,
                     noise_user=0, noise_rectified=False)


def _de_data():
    """dist_exact's inputs: _data at N_DE rows, the noise fixed at 0.1."""
    X, y, xs, hyp = _data(N_DE, M_DE, SEED + 13)
    h = hyp[0].copy()
    h[D + 1] = np.log(0.1)
    return X, y, xs, h


def phase_mesh_dist_exact(mesh, data):
    """Mesh group (a): dist_exact at config 5's width (module docstring,
    phase 26a)."""
    from gpyreg_tpu_torch.core.nlml import nlz
    from gpyreg_tpu_torch.ops import tile_kernels as TK
    from gpyreg_tpu_torch.parallel import dist_exact as DE
    from gpyreg_tpu_torch.parallel.mesh import all_gather

    X, y, xs, h = data
    spec = _se_spec(D)
    P = mesh.size
    Np, rows, _ = DE.plan(N_DE, P, DE_B)
    kappa = _kappa_bounds(X, [h])[0]
    rel = min(10.0 * kappa * EPS32, 1e-4)
    refs = {}
    for dtype, n in ((torch.float32, N_DE), (torch.float64, N_DE),
                     ("pad", N_DE_PAD)):
        dt = torch.float64 if dtype == "pad" else dtype
        Xd = torch.as_tensor(X[:n], dtype=dt, device=DEV)
        yd = torch.as_tensor(y[:n], dtype=dt, device=DEV)
        with torch.no_grad():
            refs[dtype] = float(nlz(spec, h, Xd, yd, None))
        del Xd, yd
        torch.cuda.empty_cache()
    X32, y32 = X.astype(np.float32), y.astype(np.float32)
    out, posts = {}, {}
    for alg in DE.ALGORITHMS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tm = {}
        post, _, launches = _synced(lambda: DE.dist_exact_fit(
            spec, mesh, h, X32, y32, b=DE_B, algorithm=alg, timings=tm))
        peak = torch.cuda.max_memory_allocated()
        nlml = float(post.nlml)
        upper = sum(int(torch.count_nonzero(torch.triu(s, i * rows + 1)))
                    for i, s in enumerate(post.slabs))
        errs = {k: abs(nlml - v) / abs(v) for k, v in
                (("float32", refs[torch.float32]),
                 ("float64", refs[torch.float64]))}
        print(f"dist_exact {alg}: N={N_DE} D={D} float32 b={DE_B} on {P} "
              f"shards (Np {Np}, slab {rows}x{Np} = {rows * Np * 4 / 1e9:.3f} "
              f"GB a shard, {P * rows * Np * 4 / 1e9:.3f} GB in all): build + "
              f"factor {tm['factor_s']:.3f} s, solves {tm['solve_s']:.3f} s; "
              f"peak {peak / 2**30:.2f} GiB; launches {launches}; NLML "
              f"{nlml:.6f}, single-device float32 {refs[torch.float32]:.6f} "
              f"(rel {errs['float32']:.3e}), float64 {refs[torch.float64]:.6f} "
              f"(rel {errs['float64']:.3e}), tol {rel:.3e} (min(10 kappa "
              f"eps32, 1e-4), kappa(G) <= {kappa:.1f}); nonzeros above the "
              f"diagonal {upper}")
        _expect(f"dist_exact {alg}", launches, cross=P)
        if not (max(errs.values()) <= rel and upper == 0):
            raise AssertionError(f"dist_exact {alg}: NLML or factor")
        out[alg] = {"launches": launches, "timings": tm, "peak": peak,
                    "nlml": nlml}
        posts[alg] = post
    a, b = (out[k]["nlml"] for k in DE.ALGORITHMS)
    if a != b:
        raise AssertionError("dist_exact: the two algorithms disagree")
    del posts["two_level"]
    torch.cuda.empty_cache()

    post_p, _, launches = _synced(lambda: DE.dist_exact_fit(
        spec, mesh, h, X32[:N_DE_PAD], y32[:N_DE_PAD], b=DE_B))
    nlml = float(post_p.nlml)
    err = abs(nlml - refs["pad"]) / abs(refs["pad"])
    pad_alpha = all_gather(post_p.alphas, DEV)[N_DE_PAD:]
    rows_p = post_p.Np // P
    upper = sum(int(torch.count_nonzero(torch.triu(s, i * rows_p + 1)))
                for i, s in enumerate(post_p.slabs))
    print(f"dist_exact padded: N={N_DE_PAD} on {P} shards (Np {post_p.Np}, "
          f"{post_p.Np - N_DE_PAD} padded rows); launches {launches}; NLML "
          f"{nlml:.6f}, float64 single device {refs['pad']:.6f} (rel "
          f"{err:.3e}, tol {rel:.3e}); padded alpha rows nonzero "
          f"{int(torch.count_nonzero(pad_alpha))}; nonzeros above the "
          f"diagonal {upper}")
    _expect("dist_exact padded", launches, cross=P)
    if not (post_p.Np > N_DE_PAD and err <= rel and upper == 0
            and not bool(torch.any(pad_alpha != 0))):
        raise AssertionError("dist_exact padded: NLML or padding")
    del post_p
    torch.cuda.empty_cache()

    post = posts["masked_full"]
    del posts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (mu, s2), _, launches = _synced(lambda: DE.dist_exact_predict(post, xs))
    t_pred = time.perf_counter() - t0
    del post
    torch.cuda.empty_cache()
    gp = _se_gp(D, np.float32)
    gp.update(X_new=X, y_new=y, hyp=h[None], compute_posterior=True)
    mu1, s21 = gp.predict(xs)
    del gp
    torch.cuda.empty_cache()
    err_mu = float(np.max(np.abs(mu - mu1[:, 0])))
    err_s2 = float(np.max(np.abs(s2 - s21[:, 0])))
    tol_mu = rel * max(1.0, float(np.max(np.abs(mu1))))
    tol_s2 = rel * float(np.exp(2 * h[D]))
    print(f"  dist_exact_predict at {M_DE} points: {t_pred:.3f} s, launches "
          f"{launches}; against the single-device GP.predict: max|dmu| "
          f"{err_mu:.3e} (tol {tol_mu:.3e}), max|ds2| {err_s2:.3e} (tol "
          f"{tol_s2:.3e})")
    _expect("dist_exact_predict", launches, cross=P)  # one chunk of M_DE
    if not (mu.shape == s2.shape == (M_DE,) and np.all(np.isfinite(mu))
            and np.all(s2 >= 0) and err_mu <= tol_mu and err_s2 <= tol_s2):
        raise AssertionError("dist_exact_predict disagrees with GP.predict")
    out["predict"] = {"launches": launches, "secs": t_pred}
    out["shape"] = (rows, Np)
    return out


def phase_mesh_serving(mesh, t_pred_slice):
    """Mesh group (b): GP(mesh=...) serving at config 5 (module docstring,
    phase 26b)."""
    X, y, xs, hyp = _data(N, M_TEST, SEED)
    P = mesh.size
    out = {}
    for name, m in (("single", None), ("mesh", mesh)):
        gp = _se_gp(D, np.float32, mesh=m)
        gp.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=True)
        torch.cuda.synchronize()
        (mu, s2), secs, launches = _synced(
            lambda: gp.predict(xs, separate_samples=True))
        F, V = gp.quad(xs[:M_QUAD], 0.5, compute_var=True,
                       separate_samples=True)
        out[name] = {"mu": mu, "s2": s2, "F": F, "V": V, "secs": secs,
                     "launches": launches}
        del gp
        torch.cuda.empty_cache()
    chunk, n_full, n_tail, tail = _mesh_predict_chunks(mesh)
    m, s = out["mesh"], out["single"]
    print(f"mesh serving: config 5 (N={N} D={D} S={S} float32), predict at "
          f"{M_TEST} points on {P} shards {m['secs']:.3f} s = "
          f"{M_TEST / m['secs']:.1f} pts/s ({n_full} chunks of {chunk} and "
          f"{n_tail} of {tail} a sample; launches {m['launches']}), single "
          f"device {s['secs']:.3f} s here, {t_pred_slice:.3f} s in phase 5")
    _expect("mesh predict", m["launches"], cross=S * (n_full + n_tail))
    sf2 = float(np.exp(2 * hyp[:, D].max()))
    err_mu = float(np.max(np.abs(m["mu"] - s["mu"])))
    err_s2 = float(np.max(np.abs(m["s2"] - s["s2"])))
    tol_mu = 1e-5 * float(np.max(np.abs(s["mu"])))
    print(f"  against the single-device predict: max|dmu| {err_mu:.3e} (tol "
          f"{tol_mu:.3e}), max|ds2| {err_s2:.3e} (tol {1e-5 * sf2:.3e})")
    if not (err_mu <= tol_mu and err_s2 <= 1e-5 * sf2):
        raise AssertionError("mesh predict disagrees with the single device")
    kappa = max(_kappa_bounds(X, hyp[:S_FULL]))
    rel = 10.0 * kappa * EPS32
    err_F = float(np.max(np.abs(m["F"] - s["F"])))
    err_V = float(np.max(np.abs(m["V"] - s["V"])))
    tol_F = rel * max(1.0, float(np.max(np.abs(s["F"]))))
    tol_V = rel * max(1.0, float(np.max(np.abs(s["V"]))))
    print(f"  quad over {M_QUAD} measures on the mesh against the single "
          f"device: max|dF| {err_F:.3e} (tol {tol_F:.3e}), max|dV| "
          f"{err_V:.3e} (tol {tol_V:.3e}; kappa(G) <= {kappa:.1f})")
    if not (err_F <= tol_F and err_V <= tol_V):
        raise AssertionError("mesh quad disagrees with the single device")
    return {"launches": m["launches"], "secs": m["secs"],
            "single_secs": s["secs"], "full": S * n_full, "tail": S * n_tail}


def phase_mesh_nlml_grad(mesh, X, y, hyps):
    """Mesh group (c): sharded_nlml_grad at bench.py's workload (module
    docstring, phase 26c)."""
    from gpyreg_tpu_torch.core.nlml import get_fns
    from gpyreg_tpu_torch.parallel.mesh import sharded_nlml_grad

    spec = _se_spec(D_TR)
    Xd = torch.as_tensor(X, dtype=torch.float32, device=DEV)
    yd = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    nlz_grad = get_fns(spec, False, False)["nlz_grad"]
    total = dict.fromkeys(("self", "vjp"), 0)
    for B in (B_TR, B_TR - 1):
        (v, g), secs, launches = _synced(
            lambda: sharded_nlml_grad(spec, mesh, hyps[:B], Xd, yd))
        (v1, g1), secs1, _ = _synced(lambda: nlz_grad(hyps[:B], Xd, yd))
        _check_finite(v, g, B, D_TR + 3, "sharded_nlml_grad")
        err_v = (torch.max(torch.abs(v - v1)) / torch.max(torch.abs(v1))).item()
        err_g = (torch.max(torch.abs(g - g1))
                 / torch.clamp(torch.max(torch.abs(g1)), min=1.0)).item()
        print(f"sharded_nlml_grad: N={N_TR} D={D_TR} B={B} float32 on "
              f"{mesh.size} shards {secs:.4f} s ({B / secs:.2f} evals/s; single "
              f"device {secs1:.4f} s); launches {launches}; against nlz_grad: "
              f"values {err_v:.3e}, gradients {err_g:.3e} (tol 1e-6)")
        _expect("sharded_nlml_grad", launches, self=B, vjp=B)
        if not (err_v <= 1e-6 and err_g <= 1e-6):
            raise AssertionError("sharded_nlml_grad disagrees with nlz_grad")
        for k in total:
            total[k] += launches[k]
    return {"launches": total}


def phase_mesh_fit(mesh, fit_b, windows):
    """Mesh group (d): GP(mesh=...).fit at fit_bench's size, MAP then the
    chains (module docstring, phase 26d)."""
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    n, d, options = FIT_BENCH
    X, y = _fit_data(n, d, SEED + 3)
    gp = _se_gp(d, np.float32, mesh=mesh)
    np.random.seed(SEED)
    torch.cuda.synchronize()
    TK.reset_launches()
    t0 = time.perf_counter()
    hyp, res, _ = gp.fit(X, y, options=dict(options))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(TK.LAUNCHES)
    f1 = fit_b["fun"]
    kappa = _kappa(torch.as_tensor(X, device=DEV), hyp[0])
    tol = max(1e-3, 10.0 * kappa * EPS32) * max(1.0, abs(f1))
    same = bool(np.array_equal(hyp, fit_b["hyp"]) and res.fun == f1)
    one_card = all(d == torch.device("cuda", 0) for d in mesh.devices)
    nit = sum(r.nit for r in gp.fit_report["restarts"])
    print(f"mesh fit_bench: N={n} D={d} float32 on {mesh.size} shards, options "
          f"{options}: {wall:.3f} s (single device {fit_b['wall']:.3f} s), "
          f"timings {gp.fit_timings}; launches {launches}; MAP objective "
          f"{res.fun:.6f}, single device {f1:.6f} (|d| "
          f"{abs(res.fun - f1):.3e}, tol {tol:.3e}); bitwise equal to the "
          f"single-device fit: {same}")
    if not (abs(res.fun - f1) <= tol and (same or not one_card)
            and launches["vjp"] >= nit
            and launches["self"] >= options.get("init_N", 1024) + launches["vjp"]
            and launches["cross"] == 0
            and not any(v for k, v in launches.items()
                        if k.endswith("_unaligned"))):
        raise AssertionError("mesh fit_bench: objective or launches")
    del gp
    torch.cuda.empty_cache()
    samp = phase_fit_sample(*MESH_CHAINS, windows,
                            gp=_se_gp(d, np.float32, mesh=mesh))[2]
    if samp["sr"]["n_chains"] != MESH_CHAINS[3]["n_chains"]:
        raise AssertionError("mesh chains: wrong number of chains")
    return {"launches": launches, "wall": wall, "same": same, "chains": samp}


def phase_mesh_cg(mesh, data, hyp, mv, mv_ms_23):
    """Mesh group (e): sharded_cg_weights at the CG tier's N (module
    docstring, phase 26e)."""
    from gpyreg_tpu_torch.core.model import cov_matrix, mean_value
    from gpyreg_tpu_torch.ops import iterative as IT
    from gpyreg_tpu_torch.parallel import mesh as PM

    X, y, xs = data[:3]
    count, plain_mv = mv
    spec = _se_spec(D_CG)
    rc = CG_OPTS["cg_row_chunk"]
    tol, max_iter = CG_OPTS["cg_predict_tol"], MESH_CG_MAX_ITER
    Xd = torch.as_tensor(X, dtype=torch.float32, device=DEV)
    yd = torch.as_tensor(y, dtype=torch.float32, device=DEV)
    h = torch.as_tensor(hyp, dtype=torch.float32, device=DEV)
    count[0] = 0
    (alpha, res, iters), secs, launches = _synced(
        lambda: PM.sharded_cg_weights(spec, mesh, hyp, Xd, yd, tol=tol,
                                      max_iter=max_iter))
    calls = count[0]
    with torch.no_grad():
        hc, _, hm = spec.split_hyp(h)
        sn2 = torch.full((N_CG,), float(np.exp(2 * hyp[D_CG + 1])), device=DEV)
        (a1, res1, it1), secs1, _ = _synced(lambda: IT.cg_posterior_weights(
            spec, hyp, Xd, yd, None, tol=tol, row_chunk=rc, max_iter=max_iter))

        def true_resid(a, dtype):
            """|r - (K + sn2 I) a| / |r| by the single-device matvec."""
            Xt, ht, st = Xd.to(dtype), h.to(dtype), sn2.to(dtype)
            r = yd.to(dtype) - mean_value(spec, spec.split_hyp(ht)[2], Xt)[:, None]
            Ka = plain_mv(spec, spec.split_hyp(ht)[0], Xt, a.to(dtype), st, rc)
            return (torch.linalg.norm(r - Ka) / torch.linalg.norm(r)).item()

        resid = {(w, dt): true_resid(a, dt) for w, a in (("mesh", alpha),
                                                          ("single", a1))
                 for dt in (torch.float32, torch.float64)}
        Zs = torch.as_tensor(xs, dtype=torch.float32, device=DEV)
        Ks = cov_matrix(spec, hc, Xd, Z=Zs)
        m0 = mean_value(spec, hm, Zs)
        mu, mu1 = m0 + (Ks.T @ alpha)[:, 0], m0 + (Ks.T @ a1)[:, 0]
        err_mu = (torch.max(torch.abs(mu - mu1))
                  / torch.max(torch.abs(mu1))).item()
        op = PM._RowOperator(spec, mesh, hc, Xd, sn2, torch.ones_like(sn2))
        V = torch.randn((N_CG, 1 + CG_OPTS["cg_n_probes"]), device=DEV)
        mv_ms = _time_ms(lambda: op(V), 5)
    bound = max(2 * tol, 2 * resid[("single", torch.float32)])
    print(f"sharded_cg_weights: N={N_CG} D={D_CG} float32 on {mesh.size} "
          f"shards, tol {tol}: {secs:.3f} s, {iters} iterations ({calls} shard "
          f"matvecs), CG residual {res.max().item():.3e}; launches {launches}; "
          f"single device cg_posterior_weights {secs1:.3f} s, {it1} iterations, "
          f"CG residual {res1.max().item():.3e}")
    print(f"  residual recomputed by the single-device matvec, float32 / "
          f"float64: sharded alpha "
          f"{resid[('mesh', torch.float32)]:.3e} / "
          f"{resid[('mesh', torch.float64)]:.3e}, single-device alpha "
          f"{resid[('single', torch.float32)]:.3e} / "
          f"{resid[('single', torch.float64)]:.3e}; bound max(2 tol, twice "
          f"the single device's) {bound:.3e}; mean at {M_CG} points against "
          f"the single device's: {err_mu:.3e} "
          f"(tol 1e-3); ms a sharded matvec (9 columns, as phase 23's) "
          f"{mv_ms:.3f} ms, phase 23's single-device matvec {mv_ms_23:.3f} ms")
    panels = -(-(N_CG // mesh.size) // PM._ROW_CHUNK)
    _expect("sharded_cg_weights", launches, cross=iters * mesh.size * panels)
    if not (calls == mesh.size * iters and err_mu <= 1e-3
            and resid[("mesh", torch.float32)] <= bound
            and bool(torch.all(torch.isfinite(alpha)))):
        raise AssertionError("sharded_cg_weights: residual, mean or matvecs")
    return {"launches": launches, "iters": iters, "secs": secs,
            "mv_ms": mv_ms}


def phase_mesh(mesh, de_data, t_pred_slice, X_tr, y_tr, hyps_tr, fit_b, cg,
               cg_data, mv, windows):
    """The mesh group (module docstring, phase 26), with its seconds."""
    t0 = time.perf_counter()
    out = {"dist_exact": phase_mesh_dist_exact(mesh, de_data)}
    torch.cuda.empty_cache()
    out["serving"] = phase_mesh_serving(mesh, t_pred_slice)
    torch.cuda.empty_cache()
    out["nlml_grad"] = phase_mesh_nlml_grad(mesh, X_tr, y_tr, hyps_tr)
    out["fit"] = phase_mesh_fit(mesh, fit_b, windows)
    torch.cuda.empty_cache()
    out["cg"] = phase_mesh_cg(mesh, cg_data, cg["hyp"], mv, cg["mv_ms"])
    print(f"mesh group: {time.perf_counter() - t0:.1f} s")
    return out


def _mesh_checks(mesh, X, xs, de_data):
    """Phase 3's checks of the kernel-tile shapes that only the mesh group
    runs: a dist_exact slab (held-out rows of the slab's shape against the
    N_DE rows: a slab's rows are data rows, at t2 = 0 against themselves),
    dist_exact_predict's cross and the ragged last chunk of a shard's
    predict."""
    from gpyreg_tpu_torch.parallel.dist_exact import plan

    rows = plan(N_DE, mesh.size, DE_B)[1]
    Xde, _, xsde, _ = de_data
    held = np.random.default_rng(SEED + 14).normal(size=(rows, D))
    tail = _mesh_predict_chunks(mesh)[3]
    Xs, Xd, Hd, Zd, Zt = (torch.as_tensor(a, dtype=torch.float32, device=DEV)
                          for a in (X, Xde, held, xsde, xs[:tail]))
    return (("de_slab", "cross", (Hd, Xd, False, 5)),
            ("de_pred", "cross", (Xd[:rows], Zd, False, 20)),
            ("mesh_cross_tail", "cross", (Xs, Zt, False, 10)))


def _kernels_line_slice9(kern, vjp, mg):
    """The kernels line's entries for the mesh group: each use of a kernel
    with the launches it made there, at the shape it ran."""
    from gpyreg_tpu_torch.ops.tile_kernels import PROFILES

    tile = ("gpyreg_tpu_torch/csrc/kernel_tile.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:99")
    vjpk = ("gpyreg_tpu_torch/csrc/kernel_vjp.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:184")
    de, fit = mg["dist_exact"], mg["fit"]
    chains = fit["chains"]["launches"]
    out = []
    for use, key, launches, path in (
        ("mesh dist_exact build masked_full", "de_slab",
         de["masked_full"]["launches"]["cross"], "cross"),
        ("mesh dist_exact build two_level", "de_slab",
         de["two_level"]["launches"]["cross"], "cross"),
        ("mesh dist_exact_predict", "de_pred",
         de["predict"]["launches"]["cross"], "cross"),
        ("mesh config-5 predict", "cross", mg["serving"]["full"], "cross"),
        ("mesh config-5 predict last chunk", "mesh_cross_tail",
         mg["serving"]["tail"], "cross"),
        ("mesh sharded_nlml_grad self", "self_train",
         mg["nlml_grad"]["launches"]["self"], "self"),
        ("mesh fit_bench self", "self_train", fit["launches"]["self"], "self"),
        ("mesh chains_bench self", "self_train", chains["self"], "self"),
        ("mesh sharded_cg_weights panel", "cg_panel",
         mg["cg"]["launches"]["cross"], "cross"),
    ):
        err, ms, plain_ms, n, m, d = kern[(key, "se")]
        e = _entry(f"kernel_tile[{use}, se, {n}x{m}, D={d}]", *tile, launches,
                   err, ms, plain_ms, _tile_bound(n, m, d, self_cov=path == "self"))
        e["max_abs_err_all_profiles"] = max(kern[(key, b)][0] for b in PROFILES)
        e["dispatch"] = "tma"
        out.append(e)
    for use, launches in (
        ("mesh sharded_nlml_grad", mg["nlml_grad"]["launches"]["vjp"]),
        ("mesh fit_bench", fit["launches"]["vjp"]),
        ("mesh chains_bench", chains["vjp"]),
    ):
        err, rel, ms, plain_ms, n, d = vjp[("bench", "se")]
        e = _entry(f"kernel_vjp[{use}, se, N={n}, D={d}]", *vjpk, launches, err,
                   ms, plain_ms, _vjp_bound(n, d, False))
        e["max_rel_err_all_profiles"] = max(vjp[("bench", c)][1] for c in VJP_COVS)
        out.append(e)
    return out


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
    }


def _kernels_line(kern, vjp, serve_launches, bench, cfg5, fit_b, fit_5, samp,
                  rest):
    from gpyreg_tpu_torch.ops.tile_kernels import PROFILES

    tile = ("gpyreg_tpu_torch/csrc/kernel_tile.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:99")
    vjpk = ("gpyreg_tpu_torch/csrc/kernel_vjp.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:184")
    out = []
    chain = {use: samp[k] for use, k in (
        ("fit_mala_bench", "mala"), ("fit_hmc_bench", "hmc"),
        ("fit_eissample_bench", "eissample"),
        ("fit_mala_config5", "mala_config5"))}
    for use, key, counts, path in (
        ("serving self", "self", serve_launches, "self"),
        ("serving cross", "cross", serve_launches, "cross"),
        ("config-5 training self", "self", cfg5["launches"], "self"),
        ("bench training self", "self_train", bench["launches"], "self"),
        ("fit_bench self", "self_train", fit_b["launches"], "self"),
        ("fit_config5 self", "self", fit_5["launches"], "self"),
        ("fit_sample_bench self", "self_train", samp["bench"]["launches"], "self"),
        ("fit_sample_config5 self", "self", samp["config5"]["launches"], "self"),
        ("refit_slicelite_bench self", "self_refit", samp["refit"]["launches"],
         "self"),
        ("covsample_chains_bench self", "self_train", samp["chains"]["launches"],
         "self"),
        ("gp_sample config5 cross column", "cross_col",
         samp["gp_sample"]["config5"]["launches"], "cross"),
        ("gp_sample bench cross column", "cross_col_bench",
         samp["gp_sample"]["bench"]["launches"], "cross"),
        ("fit_mala_bench self", "self_train", chain["fit_mala_bench"]["launches"],
         "self"),
        ("fit_hmc_bench self", "self_train", chain["fit_hmc_bench"]["launches"],
         "self"),
        ("fit_eissample_bench self", "self_train",
         chain["fit_eissample_bench"]["launches"], "self"),
        ("fit_mala_config5 self", "self", chain["fit_mala_config5"]["launches"],
         "self"),
        # Phase 9a: the rank-1 updates' columns, one entry an update.
        *((f"rank-1 update {k + 1} cross column", f"cross_r1_{k}", c, "cross")
          for k, c in enumerate(rest["rank1"])),
        ("predict_full self", "self_pf", rest["predict_full"], "self"),
        ("predict_full cross", "cross_pf", rest["predict_full"], "cross"),
        ("random_function self", "self_pf", rest["random_function"], "self"),
        ("random_function cross", "cross_pf", rest["random_function"],
         "cross"),
        ("random_function draws self", "self_64", rest["random_draws"], "self"),
        ("random_function draws cross", "cross_64", rest["random_draws"],
         "cross"),
        ("predict 256 cross", "cross_256", rest["predict"], "cross"),
        ("predict_quantile cross", "cross_256", rest["predict_quantile"],
         "cross"),
    ):
        err, ms, plain_ms, n, m, d = kern[(key, "se")]
        # The one-column crosses run on the path without TMA.
        launches = counts[path + "_unaligned"
                          if key.startswith(("cross_col", "cross_r1"))
                          else path]
        e = _entry(f"kernel_tile[{use}, se, {n}x{m}, D={d}]", *tile,
                   launches, err, ms, plain_ms,
                   _tile_bound(n, m, d, self_cov=path == "self"))
        e["max_abs_err_all_profiles"] = max(kern[(key, b)][0] for b in PROFILES)
        # The main path's launches by dispatch: TMA store, or plain stores.
        e["launches_by_dispatch"] = {"tma": counts[path],
                                     "unaligned": counts[path + "_unaligned"]}
        if key == "cross":
            tail = kern[("cross_tail", "se")]
            e["tail_ms"], e["tail_plain_ms"] = tail[1], tail[2]
            e["tail_bound_ms"] = _tile_bound(tail[3], tail[4], tail[5])[0]
        if use in ("serving cross", "bench training self"):
            # The path without TMA, held to the plain version in phase 3.
            ukey = "cross_unaligned" if key == "cross" else "self_unaligned"
            uerr, ums, uplain, un, um, ud = kern[(ukey, "se")]
            e["unaligned_check"] = {
                "shape": f"{un}x{um}, D={ud}",
                "max_abs_err_all_profiles": max(kern[(ukey, b)][0]
                                                for b in PROFILES),
                "ms": ums, "plain_ms": uplain,
                "bound_ms": _tile_bound(un, um, ud,
                                        self_cov=ukey == "self_unaligned")[0],
            }
        if use == "bench training self":
            e["python_float_ms"] = kern["python_float"][1]
        phase = use[: -len(" self")]
        if phase in chain:
            # The chain's own launches and density calls.
            e["chain_window_launches"] = chain[phase]["window"][path]
            e["chain_calls"] = chain[phase]["calls"]
        out.append(e)
    for use, label, counts in (
        ("bench training", "bench", bench["launches"]),
        ("config-5 training", "config5", cfg5["launches"]),
        ("fit_bench", "bench", fit_b["launches"]),
        ("fit_config5", "config5", fit_5["launches"]),
        ("fit_sample_bench", "bench", samp["bench"]["launches"]),
        ("fit_sample_config5", "config5", samp["config5"]["launches"]),
        ("fit_mala_bench", "bench", chain["fit_mala_bench"]["launches"]),
        ("fit_hmc_bench", "bench", chain["fit_hmc_bench"]["launches"]),
        ("fit_eissample_bench", "bench", chain["fit_eissample_bench"]["launches"]),
        ("fit_mala_config5", "config5", chain["fit_mala_config5"]["launches"]),
    ):
        err, rel, ms, plain_ms, n, d = vjp[(label, "se")]
        e = _entry(f"kernel_vjp[{use}, se, N={n}, D={d}]", *vjpk,
                   counts["vjp"], err, ms, plain_ms, _vjp_bound(n, d, False))
        e["max_rel_err_all_profiles"] = max(
            vjp[(label, c)][1] for c in VJP_COVS)
        e["launches_by_dispatch"] = {"tma": counts["vjp"],
                                     "unaligned": counts["vjp_unaligned"]}
        if use == "bench training":
            uerr, urel, ums, uplain, un, ud = vjp[("bench_unaligned", "se")]
            e["unaligned_check"] = {
                "shape": f"N={un}, D={ud}",
                "max_rel_err_all_profiles": max(
                    vjp[("bench_unaligned", c)][1] for c in VJP_COVS),
                "ms": ums, "plain_ms": uplain,
                "bound_ms": _vjp_bound(un, ud, False)[0],
            }
            e["python_float_ms"] = vjp["python_float"][1]
        if use in chain:
            # MALA and HMC launch it once a value-and-gradient call; the
            # ensemble chain is value-only (its MAP launches it).
            e["chain_window_launches"] = chain[use]["window"]["vjp"]
            e["chain_calls"] = chain[use]["calls"]
        out.append(e)
    return out


def _kernels_line_slice8(kern, vjp, cg, fid, ow):
    """The kernels line's entries for the matrix-free tier and output
    warping: each new kernel-1 shape with the launches each use made."""
    from gpyreg_tpu_torch.ops.tile_kernels import PROFILES

    tile = ("gpyreg_tpu_torch/csrc/kernel_tile.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:99")
    vjpk = ("gpyreg_tpu_torch/csrc/kernel_vjp.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:184")
    panels = N_CG // CG_OPTS["cg_row_chunk"]
    panels_b = N_CG_B // CG_OPTS["cg_row_chunk"]
    pred_panels = panels * cg["pred_matvecs"]
    fid_pred_panels = sum(panels_b * p["matvecs"] for p in fid["pred"].values())
    out = []
    for use, key, launches, path in (
        ("cg_65536 fit panel", "cg_panel", cg["fit_launches"]["cross"], "cross"),
        ("cg_65536 predict panel", "cg_panel", pred_panels, "cross"),
        ("cg_65536 predict cross", "cg_cross",
         cg["pred_launches"]["cross"] - pred_panels, "cross"),
        ("cg_fidelity_8192 fit panel", "cg_panel_8192",
         fid["fit_launches"]["cross"], "cross"),
        ("cg_fidelity_8192 estimator panel", "cg_panel_128",
         fid["est_launches"]["cross"], "cross"),
        ("cg_fidelity_8192 cg_predict panel", "cg_panel_8192", fid_pred_panels,
         "cross"),
        ("cg_fidelity_8192 cg_predict cross", "cg_cross_8192",
         sum(p["launches"]["cross"] for p in fid["pred"].values())
         - fid_pred_panels, "cross"),
        ("cg_fidelity_8192 pivoted Cholesky column", "cg_column_8192",
         fid["pred"][CG_PRECOND_RANK]["launches"]["cross_unaligned"],
         "cross_unaligned"),
        ("cg_fidelity_8192 chain panel", "cg_panel_8192",
         fid["chain_launches"]["cross"], "cross"),
        ("outwarp_config5 fit self", "self", ow["fit_launches"]["self"], "self"),
        ("outwarp_config5 predict cross", "cross", ow["pred_launches"]["cross"],
         "cross"),
        ("outwarp_config5 predict_quantile cross", "cross_256_ow",
         ow["q_launches"]["cross"], "cross"),
        ("outwarp_fit_sample_bench self", "self_train",
         ow["sample"]["launches"]["self"], "self"),
    ):
        err, ms, plain_ms, n, m, d = kern[(key, "se")]
        e = _entry(f"kernel_tile[{use}, se, {n}x{m}, D={d}]", *tile, launches,
                   err, ms, plain_ms, _tile_bound(n, m, d, self_cov=path == "self"))
        e["max_abs_err_all_profiles"] = max(kern[(key, b)][0] for b in PROFILES)
        e["dispatch"] = "unaligned" if path.endswith("_unaligned") else "tma"
        if use == "outwarp_config5 predict cross":
            tail = kern[("cross_tail", "se")]
            e["tail_ms"], e["tail_plain_ms"] = tail[1], tail[2]
            e["tail_bound_ms"] = _tile_bound(tail[3], tail[4], tail[5])[0]
        out.append(e)
    for use, label, launches in (
        ("outwarp_config5 fit", "config5", ow["fit_launches"]["vjp"]),
        ("outwarp_fit_sample_bench", "bench", ow["sample"]["launches"]["vjp"]),
    ):
        err, rel, ms, plain_ms, n, d = vjp[(label, "se")]
        e = _entry(f"kernel_vjp[{use}, se, N={n}, D={d}]", *vjpk, launches, err,
                   ms, plain_ms, _vjp_bound(n, d, False))
        e["max_rel_err_all_profiles"] = max(vjp[(label, c)][1] for c in VJP_COVS)
        out.append(e)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gpyreg_tpu_torch  # noqa: F401 (fails here outside a checkout)

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    X, y, xs, hyp = _data(N, M_TEST, SEED)
    X_tr, y_tr, hyps_tr = _train_data(N_TR, SEED)
    cg_data = _cg_data()
    mesh = _smoke_mesh()
    de_data = _de_data()
    kern = phase_kernel_vs_plain(X, xs, X_tr, cg_data,
                                 _mesh_checks(mesh, X, xs, de_data))
    vjp = phase_vjp_vs_plain((("bench", X_tr, y_tr, hyps_tr[0]),
                              ("bench_unaligned", X_tr[:N_TR - 1],
                               y_tr[:N_TR - 1], hyps_tr[0]),
                              ("config5", X, y, hyp[0])))
    torch.cuda.empty_cache()
    gp, serve_launches, t_pred_slice = phase_slice(X, y, xs, hyp)
    phase_full_size_accuracy(gp, X, y, xs, hyp)
    cfg5 = phase_train_config5(gp, hyp)
    rest = phase_serving_rest(gp, X, y, xs, hyp)
    del gp
    torch.cuda.empty_cache()
    phase_accuracy()
    gp_bench, bench = phase_train_bench(X_tr, y_tr, hyps_tr)
    phase_grad_accuracy(gp_bench, X_tr, y_tr, hyps_tr)
    del gp_bench
    torch.cuda.empty_cache()
    phase_fit_warm()
    fit_b = phase_fit("fit_bench", *FIT_BENCH, compare_float64=True)
    torch.cuda.empty_cache()
    fit_5 = phase_fit("fit_config5", *FIT_CONFIG5, compare_float64=False)

    windows = _count_chain_windows()
    samp = {}
    torch.cuda.empty_cache()
    gp_b, data_b, samp["bench"] = phase_fit_sample(*FIT_SAMPLE_BENCH, windows,
                                                   compare_float64=True)
    hyp_b = gp_b.get_hyperparameters(as_array=True)
    torch.cuda.empty_cache()
    gp_5, data_5, samp["config5"] = phase_fit_sample(*FIT_SAMPLE_CONFIG5, windows)
    torch.cuda.empty_cache()
    _, samp["refit"] = phase_refit_slicelite(gp_b, data_b, windows)
    del gp_b
    torch.cuda.empty_cache()
    _, _, samp["chains"] = phase_fit_sample(*COVSAMPLE_CHAINS, windows)
    torch.cuda.empty_cache()
    samp["gp_sample"] = phase_gp_sample(gp_5, data_5, data_b, hyp_b, windows)
    del gp_5
    for key, spec, grad_check in (("mala", FIT_MALA_BENCH, True),
                                  ("hmc", FIT_HMC_BENCH, False),
                                  ("eissample", FIT_EISSAMPLE_BENCH, False),
                                  ("mala_config5", FIT_MALA_CONFIG5, False)):
        torch.cuda.empty_cache()
        samp[key] = phase_fit_mala_hmc_ensemble(*spec, windows,
                                                grad_check=grad_check)

    torch.cuda.empty_cache()
    mv = _count_matvecs()
    cg = phase_cg_65536(cg_data, mv)
    torch.cuda.empty_cache()
    fid = phase_cg_fidelity(cg_data, mv)
    torch.cuda.empty_cache()
    ow = phase_outwarp(windows)
    torch.cuda.empty_cache()
    mg = phase_mesh(mesh, de_data, t_pred_slice, X_tr, y_tr, hyps_tr, fit_b,
                    cg, cg_data, mv, windows)

    print(json.dumps({"kernels": _kernels_line(kern, vjp, serve_launches,
                                                bench, cfg5, fit_b, fit_5,
                                                samp, rest)
                      + _kernels_line_slice8(kern, vjp, cg, fid, ow)
                      + _kernels_line_slice9(kern, vjp, mg)}))
    print(f"wall: {time.perf_counter() - t_start:.1f} s")
    print(f"card (name, power limit): {smi}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
