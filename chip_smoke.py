#!/usr/bin/env python3
"""Drive the PyTorch port (gpyreg_tpu_torch) once on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: the card's name and power limit, torch and CUDA versions;
   TF32 off for matmuls and convolutions;
2. build: compile the kernel tile (csrc/kernel_tile.cu) from the
   checkout's sources and report the seconds it took;
3. kernel vs plain: the kernel tile against its plain PyTorch version on
   the card, all five profiles, at the shapes the slice gives it: the
   self-covariance 16384 x 16384 with zero_diag, and the
   cross-covariance of a full predict chunk (16384 x 16384) and of the
   ragged last chunk (16384 x 1696), D = 10;
4. the serving slice at full size (BASELINE.json config 5): an ARD-SE GP
   with constant mean and constant noise, N = 16384, D = 10, 8
   hyperparameter samples, float32, ``update`` then ``predict`` on
   100,000 test points, through the GP's default options; the kernel's
   launch counts prove the path ran through it;
5. full-size accuracy: 2 of those samples at 256 of the test points
   against a float64 build of the same GP on the card, at a tolerance set
   from a bound on the condition number of K + sn2 I;
6. accuracy: the same float32 GP on the card against the port's float64
   GP on the CPU, at N = 2048 and M = 4096, all 8 samples.

Prints a JSON line of per-kernel results, then, last, the
``{"ok": true, "device": ...}`` line.  Imports nothing of JAX.  Exits
non-zero, with no result, when no CUDA device is available.
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
# Kernel (direct differences) vs the plain norm-expansion version in
# float32, the tolerance of tests/test_fused_kernel.py:46.
KERNEL_TOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


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
    lib_path = _build.build("kernel_tile")
    _build.kernel_tile_lib()
    secs = time.perf_counter() - t0
    print(f"build: kernel_tile in {secs:.2f} s -> {os.path.relpath(lib_path)}")
    with open(lib_path[: -len(".so")] + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    return secs


def _chunks():
    """The test-point chunk of the slice's predict and its ragged tail."""
    from gpyreg_tpu_torch.gp import _PREDICT_CHUNK_ELEMS

    chunk = min(M_TEST, _PREDICT_CHUNK_ELEMS // N)
    return chunk, M_TEST - chunk * ((M_TEST - 1) // chunk)


def phase_kernel_vs_plain(X, xs):
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    dev = torch.device("cuda")
    chunk, tail = _chunks()
    Xs = torch.as_tensor(X, dtype=torch.float32, device=dev)
    Zc = torch.as_tensor(xs[:chunk], dtype=torch.float32, device=dev)
    Zt = torch.as_tensor(xs[-tail:], dtype=torch.float32, device=dev)
    sf2, alpha = float(np.exp(0.2)), float(np.exp(0.3))
    results = {}
    for use, (A, B, zd, reps) in (
        ("self", (Xs, Xs, True, 5)),
        ("cross", (Xs, Zc, False, 5)),
        ("cross_tail", (Xs, Zt, False, 20)),
    ):
        for base in TK.PROFILES:
            K = TK.kernel_cross(base, A, B, sf2, alpha, zero_diag=zd)
            ref = TK.kernel_cross_ref(base, A, B, sf2, alpha, zero_diag=zd)
            torch.cuda.synchronize()
            err = torch.max(torch.abs(K - ref)).item()
            del K, ref
            t_plain = [_time_ms(lambda: TK.kernel_cross_ref(
                base, A, B, sf2, alpha, zero_diag=zd), reps)]
            t_kern = [_time_ms(lambda: TK.kernel_cross(
                base, A, B, sf2, alpha, zero_diag=zd), reps)]
            t_kern.append(_time_ms(lambda: TK.kernel_cross(
                base, A, B, sf2, alpha, zero_diag=zd), reps))
            t_plain.append(_time_ms(lambda: TK.kernel_cross_ref(
                base, A, B, sf2, alpha, zero_diag=zd), reps))
            ms, plain_ms = float(np.mean(t_kern)), float(np.mean(t_plain))
            print(f"kernel {use:10s} {base}: {A.shape[0]}x{B.shape[0]} "
                  f"max_abs_err={err:.3e} kernel {ms:.4f} ms "
                  f"(runs {t_kern}) plain {plain_ms:.4f} ms (runs {t_plain})")
            if not err < KERNEL_TOL:
                raise AssertionError(
                    f"kernel_tile {use} {base}: max abs error {err} "
                    f">= {KERNEL_TOL}"
                )
            results[(use, base)] = (err, ms, plain_ms, B.shape[0])
    return results


def phase_slice(X, y, xs, hyp):
    import gpyreg_tpu_torch as gt
    from gpyreg_tpu_torch.ops import tile_kernels as TK

    gp = gt.GP(
        D,
        gt.covariance_functions.SquaredExponential(),
        gt.mean_functions.ConstantMean(),
        gt.noise_functions.GaussianNoise(constant_add=True),
        dtype=np.float32,
        device="cuda",
    )
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
    if launches != {"self": S, "cross": S * n_chunks}:
        raise AssertionError(
            f"kernel launches {launches}, expected {S} self and "
            f"{S * n_chunks} cross"
        )
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
    gp64 = gp_from_arrays(meta, X, y, None, hyp[:S_FULL], "cuda")
    mu64, s264 = gp64._group_predict(sub)
    del gp64
    mu32, s232 = gp32._group_predict(sub)
    mu32, s232 = mu32[:, :S_FULL], s232[:, :S_FULL]

    Xd = torch.as_tensor(X, device="cuda")
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


def phase_accuracy():
    from gpyreg_tpu_torch.convert import gp_from_arrays

    X, y, xs, hyp = _data(N_ACC, M_ACC, SEED + 1)
    meta = {"D": D, "cov_kind": "se", "mean_kind": "const",
            "noise_parameters": [1, 0, 0]}
    gp32 = gp_from_arrays({**meta, "dtype": "float32"}, X, y, None, hyp, "cuda")
    gp64 = gp_from_arrays({**meta, "dtype": "float64"}, X, y, None, hyp, "cpu")
    mu32, s232 = gp32.predict(xs, separate_samples=True)
    mu64, s264 = gp64.predict(xs, separate_samples=True)

    # Conditioning of the first sample's G = K + sn2 I in float64 on the
    # CPU: the float32 solves lose about kappa * eps32 relative accuracy.
    from gpyreg_tpu_torch.ops.kernels import kernel_matrix

    Xt = torch.as_tensor(X)
    K = kernel_matrix("se", torch.as_tensor(hyp[0, : D + 1]), Xt)
    sn2 = float(np.exp(2 * hyp[0, D + 1]))
    lam = torch.linalg.eigvalsh(K).numpy()
    kappa = (lam[-1] + sn2) / (max(lam[0], 0.0) + sn2)
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import gpyreg_tpu_torch  # noqa: F401 (fails here outside a checkout)

    smi = phase_device()
    phase_build()
    X, y, xs, hyp = _data(N, M_TEST, SEED)
    kern = phase_kernel_vs_plain(X, xs)
    torch.cuda.empty_cache()
    gp, launches = phase_slice(X, y, xs, hyp)
    phase_full_size_accuracy(gp, X, y, xs, hyp)
    del gp
    torch.cuda.empty_cache()
    phase_accuracy()

    from gpyreg_tpu_torch.ops.tile_kernels import PROFILES

    kernels = []
    for use, shapes in (("self", ("self",)), ("cross", ("cross", "cross_tail"))):
        se = [kern[(u, "se")] for u in shapes]
        cols = " and ".join(f"{N}x{r[3]}" for r in se)
        entry = {
            "name": f"kernel_tile[{use}, se, {cols}, D={D}]",
            "route": "cuda",
            "source": "gpyreg_tpu_torch/csrc/kernel_tile.cu",
            "replaces": "gpyreg_tpu/ops/pallas_kernels.py:99",
            "launches": launches[use],
            "max_abs_err": max(r[0] for r in se),
            "ms": se[0][1],
            "plain_ms": se[0][2],
            "max_abs_err_all_profiles": max(
                kern[(u, b)][0] for u in shapes for b in PROFILES
            ),
        }
        if len(se) > 1:
            entry["tail_ms"], entry["tail_plain_ms"] = se[1][1], se[1][2]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
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
