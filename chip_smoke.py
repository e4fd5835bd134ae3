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
   started at once; the seconds taken and the ptxas lines of each;
3. kernel tile vs plain: the forward tile against its plain PyTorch
   version on the card, all five profiles, at the shapes the paths give
   it: the self-covariance 16384 x 16384 with zero_diag, the
   cross-covariance of a full predict chunk (16384 x 16384) and of the
   ragged last chunk (16384 x 1696), D = 10, and the training
   self-covariance 4096 x 4096, D = 8;
4. gradient tile vs plain: the one-pass gradient kernel against its
   plain version at N = 4096, D = 8 and N = 16384, D = 10, the five ARD
   profiles and se_iso, m1_iso, with the cotangent the training path
   gives it, 0.5 G^-1 - alpha alpha^T of a real G = K + sn2 I;
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
10. gradient accuracy: at N = 2048, D = 8, 8 lanes, the float32 card
    gradient against the port's float64 gradient on the CPU; at N = 4096,
    2 lanes against a float64 build on the card; per entry
    |dg| <= max(1e-3, 10 kappa eps32) max(|g64|, 1), kappa = cond(G).

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


def _train_data(n, seed):
    """bench.py's inputs (bench.py:48-57): float32 X, y and B
    hyperparameter vectors, returned as float64 arrays of those values."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D_TR)).astype(np.float32)
    y = (np.sum(np.sin(X), axis=1, keepdims=True)
         + 0.1 * rng.normal(size=(n, 1))).astype(np.float32)
    hyps = (0.05 * rng.normal(size=(B_TR, D_TR + 3))).astype(np.float32)
    return (a.astype(np.float64) for a in (X, y, hyps))


def _se_gp(d, dtype, device=None):
    import gpyreg_tpu_torch as gt

    return gt.GP(
        d,
        gt.covariance_functions.SquaredExponential(),
        gt.mean_functions.ConstantMean(),
        gt.noise_functions.GaussianNoise(constant_add=True),
        dtype=dtype,
        device=DEV if device is None else device,
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


def _tile_bound(n, m, d):
    """Kernel tile: reads Xs and Zs, writes K; 3 FP32 operations per
    entry and dimension (a subtraction and a fused multiply-add)."""
    return _bound(4 * (n * m + (n + m) * d), n * m * 3 * d)


def _vjp_bound(n, d, iso):
    """Gradient tile: reads Gbar and Xs once, writes the gradient row;
    per entry 3 operations per dimension for t2, 2 more per dimension for
    the ARD contraction (with the squared differences kept), and 6 for
    the profile, E and the sums."""
    return _bound(4 * (n * n + n * d + d + 2),
                  n * n * ((3 if iso else 5) * d + 6))


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
    from gpyreg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    _build.kernel_tile_lib()
    _build.kernel_vjp_lib()
    secs = time.perf_counter() - t0
    print(f"build: {', '.join(libs)} in {secs:.2f} s (one nvcc each, "
          f"started together)")
    for name, path in libs.items():
        print(f"  {name} -> {os.path.relpath(path)}")
        with open(path[: -len(".so")] + ".log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}:", line.strip())
    return secs


def _chunks():
    """The test-point chunk of the slice's predict and its ragged tail."""
    from gpyreg_tpu_torch.gp import _PREDICT_CHUNK_ELEMS

    chunk = min(M_TEST, _PREDICT_CHUNK_ELEMS // N)
    return chunk, M_TEST - chunk * ((M_TEST - 1) // chunk)


def phase_kernel_vs_plain(X, xs, X_tr):
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    chunk, tail = _chunks()
    Xs = torch.as_tensor(X, dtype=torch.float32, device=DEV)
    Zc = torch.as_tensor(xs[:chunk], dtype=torch.float32, device=DEV)
    Zt = torch.as_tensor(xs[-tail:], dtype=torch.float32, device=DEV)
    Xt = torch.as_tensor(X_tr, dtype=torch.float32, device=DEV)
    sf2, alpha = float(np.exp(0.2)), float(np.exp(0.3))
    results = {}
    for use, (A, B, zd, reps) in (
        ("self", (Xs, Xs, True, 5)),
        ("cross", (Xs, Zc, False, 5)),
        ("cross_tail", (Xs, Zt, False, 20)),
        ("self_train", (Xt, Xt, True, 20)),
    ):
        for base in TK.PROFILES:
            K = TK.kernel_cross(base, A, B, sf2, alpha, zero_diag=zd)
            ref = TK.kernel_cross_ref(base, A, B, sf2, alpha, zero_diag=zd)
            torch.cuda.synchronize()
            err = torch.max(torch.abs(K - ref)).item()
            del K, ref
            ms, plain_ms, t_kern, t_plain = _turns(
                lambda: TK.kernel_cross(base, A, B, sf2, alpha, zero_diag=zd),
                lambda: TK.kernel_cross_ref(base, A, B, sf2, alpha,
                                            zero_diag=zd),
                reps,
            )
            print(f"kernel_tile {use:10s} {base}: {A.shape[0]}x{B.shape[0]} "
                  f"D={A.shape[1]} max_abs_err={err:.3e} kernel {ms:.4f} ms "
                  f"(runs {t_kern}) plain {plain_ms:.4f} ms (runs {t_plain})")
            if not err < KERNEL_TOL:
                raise AssertionError(
                    f"kernel_tile {use} {base}: max abs error {err} "
                    f">= {KERNEL_TOL}"
                )
            results[(use, base)] = (err, ms, plain_ms, A.shape[0],
                                    B.shape[0], A.shape[1])
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

    sf2, alpha = float(np.exp(0.2)), float(np.exp(0.3))
    results = {}
    for label, X, y, hyp in cases:
        Xs, Gbar = _path_cotangent(X, y, hyp)
        n, d = Xs.shape
        reps = 20 if n <= 4096 else 3
        for cov in VJP_COVS:
            iso = cov.endswith("_iso")
            base = cov[:-4] if iso else cov
            g = TK.vjp_tile(base, iso, Xs, Gbar, sf2, alpha)
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
            print(f"kernel_vjp {label} {cov}: N={n} D={d} width {g.numel()} "
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
    want = {"self": S, "cross": S * n_chunks, "vjp": 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    return gp, launches


def phase_full_size_accuracy(gp32, X, y, xs, hyp):
    """The first S_FULL samples of the full-size float32 GP, at M_FULL test
    points spread over all chunks, against a float64 build of the same GP
    on the card.  Raw predictive variances (before ``predict`` clamps them
    at 0) are compared.  The float32 solves lose about kappa * eps32
    relative accuracy, with kappa = cond(K + sn2 I) <= (lambda_max(K) +
    sn2) / sn2 (K is positive semi-definite); lambda_max comes from power
    iteration in float64."""
    from gpyreg_tpu_torch.convert import gp_from_arrays
    from gpyreg_tpu_torch.ops.kernels import kernel_matrix

    sub = xs[:: M_TEST // M_FULL][:M_FULL]
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0], "dtype": "float64"}
    gp64 = gp_from_arrays(meta, X, y, None, hyp[:S_FULL], DEV)
    mu64, s264 = gp64._group_predict(sub)
    del gp64
    mu32, s232 = gp32._group_predict(sub)
    mu32, s232 = mu32[:, :S_FULL], s232[:, :S_FULL]

    Xd = torch.as_tensor(X, device=DEV)
    kappa = 0.0
    for s in range(S_FULL):
        K = kernel_matrix("se", torch.as_tensor(hyp[s, : D + 1]), Xd)
        sn2 = float(np.exp(2 * hyp[s, D + 1]))
        v = torch.ones(N, dtype=K.dtype, device=K.device) / np.sqrt(N)
        for _ in range(50):
            v = K @ v
            v /= torch.linalg.norm(v)
        lam_max = float(v @ (K @ v))
        kappa = max(kappa, (lam_max + sn2) / sn2)
        del K
    torch.cuda.empty_cache()
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
    if launches != {"self": calls, "cross": 0, "vjp": calls}:
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
    if (after_ll != {"self": 1, "cross": 0, "vjp": 1}
            or after_lp != {"self": 2, "cross": 0, "vjp": 2}):
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
    if lb_launches != {"self": res.nfev, "cross": 0, "vjp": res.nfev}:
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
    if launches != {"self": S, "cross": 0, "vjp": S}:
        raise AssertionError(f"config-5 training launches {launches}")
    return {"secs_per_lane": secs / S, "peak": peak, "launches": launches}


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


def _kernels_line(kern, vjp, serve_launches, bench, cfg5):
    from gpyreg_tpu_torch.ops.tile_kernels import PROFILES

    tile = ("gpyreg_tpu_torch/csrc/kernel_tile.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:99")
    vjpk = ("gpyreg_tpu_torch/csrc/kernel_vjp.cu",
            "gpyreg_tpu/ops/pallas_kernels.py:184")
    out = []
    for use, key, launches in (
        ("serving self", "self", serve_launches["self"]),
        ("serving cross", "cross", serve_launches["cross"]),
        ("config-5 training self", "self", cfg5["launches"]["self"]),
        ("bench training self", "self_train", bench["launches"]["self"]),
    ):
        err, ms, plain_ms, n, m, d = kern[(key, "se")]
        e = _entry(f"kernel_tile[{use}, se, {n}x{m}, D={d}]", *tile, launches,
                   err, ms, plain_ms, _tile_bound(n, m, d))
        e["max_abs_err_all_profiles"] = max(kern[(key, b)][0] for b in PROFILES)
        if key == "cross":
            tail = kern[("cross_tail", "se")]
            e["tail_ms"], e["tail_plain_ms"] = tail[1], tail[2]
            e["tail_bound_ms"] = _tile_bound(tail[3], tail[4], tail[5])[0]
        out.append(e)
    for use, label, launches in (
        ("bench training", "bench", bench["launches"]["vjp"]),
        ("config-5 training", "config5", cfg5["launches"]["vjp"]),
    ):
        err, rel, ms, plain_ms, n, d = vjp[(label, "se")]
        e = _entry(f"kernel_vjp[{use}, se, N={n}, D={d}]", *vjpk, launches,
                   err, ms, plain_ms, _vjp_bound(n, d, False))
        e["max_rel_err_all_profiles"] = max(
            vjp[(label, c)][1] for c in VJP_COVS)
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
    kern = phase_kernel_vs_plain(X, xs, X_tr)
    vjp = phase_vjp_vs_plain((("bench", X_tr, y_tr, hyps_tr[0]),
                              ("config5", X, y, hyp[0])))
    torch.cuda.empty_cache()
    gp, serve_launches = phase_slice(X, y, xs, hyp)
    phase_full_size_accuracy(gp, X, y, xs, hyp)
    cfg5 = phase_train_config5(gp, hyp)
    del gp
    torch.cuda.empty_cache()
    phase_accuracy()
    gp_bench, bench = phase_train_bench(X_tr, y_tr, hyps_tr)
    phase_grad_accuracy(gp_bench, X_tr, y_tr, hyps_tr)

    print(json.dumps({"kernels": _kernels_line(kern, vjp, serve_launches,
                                                bench, cfg5)}))
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
