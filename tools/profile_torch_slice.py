#!/usr/bin/env python3
"""Profile the PyTorch port's serving, training and fit slices on one CUDA card.

Run from the root of a checkout, on a machine with a card:

    python3 tools/profile_torch_slice.py [--trace PATH] [--group GROUP]

It builds the config-5 GP of ``chip_smoke.py`` (N = 16384, D = 10, 8
hyperparameter samples, float32, 100,000 test points, data from seed 0)
and the training GP of bench.py's workload (N = 4096, D = 8, 8
hyperparameter vectors, float32, ``chip_smoke._train_data``), takes the
``fit_bench`` workload of ``chip_smoke.py`` (``GP.fit`` without sampling
at its defaults, N = 4096, D = 8, float32, a new GP for each fit, span
``fit_4096``) and its ``fit_sample_bench`` workload (``GP.fit`` with
hyperposterior sampling at its defaults on the same data, span
``fit_sample_4096``, with the chain's own span ``fit_sample_4096_chain``
around ``inference.sampling.run_sampling``) and its ``fit_mala_bench`` and
``fit_hmc_bench`` workloads (the MALA and HMC fits on the same data,
spans ``fit_mala_4096`` and ``fit_hmc_4096`` with their chains' spans
``fit_mala_4096_chain`` and ``fit_hmc_4096_chain``), and the rest of
serving on a second config-5 GP (the calls of ``chip_smoke.py``'s phase
9a: a single-point ``update``, span ``rank1_update``, after one that
frees the build's shared allocation; ``predict_full`` at 1,024 points,
``predict_full_1024``; ``quad`` over 64 measures with ``compute_var``,
``quad_64``; one ``random_function`` draw at 1,024 points,
``random_function_1024``; ``fmin`` with 3 starts, ``fmin``), and then:

1. warms up with one ``update``, one ``predict`` and one batched NLML
   value and gradient (``get_fns(...)["nlz_grad"]``) of each GP, one
   fit, and one call of each span of the rest of serving;
2. runs one ``update``, one ``predict`` and one batched NLML value and
   gradient of each GP (spans ``nlml_grad_16384`` and ``nlml_grad_4096``)
   under ``torch.profiler`` (CPU and CUDA activities), each inside a
   ``record_function`` span that ends with a synchronize, and exports
   the Chrome trace to ``--trace``; then each fit in a profiler run
   and a trace file of its own (``--trace`` with ``.<span>.json``
   appended, removed once it is read: it holds every kernel of 1024
   design rows, and of the chain).
   From the trace's events it reports, for each span: its wall time; the
   device busy time, the union of the intervals of the ``kernel``,
   ``gpu_memcpy`` and ``gpu_memset`` events inside the span (device
   events only, so an operator and the kernels under it are never
   counted twice); the device idle share, 1 - busy / wall; and the device
   time of each kernel name (the largest 12), as a share of the wall;
3. runs each span three times more without the profiler, on the host
   clock and ending with a synchronize, and reports the median wall and
   the idle share 1 - busy / that wall (for a chain's span, the
   median of its fits' ``fit_timings["sample_s"]``).  The profiler's CPU
   tracing stretches the host's share of a span whose wall the host
   sets; this share leaves that cost out (device busy time is taken from
   step 2);
4. runs each batched NLML value and gradient, each fit, and the
   ``rank1_update``, ``predict_full_1024`` and ``fmin`` spans once more
   under its own profiler run and reports each ``aten`` operator's self
   device time (``key_averages``: the kernels the operator launches itself, not
   those of the operators it calls, so no kernel is counted twice) as a
   share of that run's host-clock wall: ``linalg_cholesky_ex`` is potrf,
   ``cholesky_inverse`` the G^-1 of the adjoint;
5. sweeps the test-point chunk of ``predict`` through 4096, 8192, 16384,
   8192, 4096 and 16384 points, in that order so that drift shows, and
   reports points/s for each;
6. profiles the matrix-free tier and output warping: ``GP.fit`` with
   ``chip_smoke.CG_OPTS`` (method "cg", ``cg_max_opt_iter`` cut to 10) on
   the N = 65,536, D = 4 data of ``chip_smoke._cg_data`` (span
   ``cg_fit_65536``, after a warm-up fit at N = 8192), ``predict`` at its
   512 held-out points with the CG weights dropped before every run, so
   that each run solves them (``cg_predict_512``), and the warped MAP fit
   of ``chip_smoke.phase_outwarp`` (N = 16384, D = 10, NegativePowerC1,
   ``outwarp_fit_16384``); each span is profiled once in a trace of its
   own, then run without the profiler (once for the CG fit, which takes
   a minute or more, three times for the others) and once more for its
   operator table.

``--group exact`` runs steps 1-5, ``--group matrix_free`` step 6, and
the default both; ``--spans`` picks step 6's spans (``cg_fit``,
``cg_predict``, ``outwarp_fit``; all by default).  The CG fit's trace
holds every panel of every matvec: with all three spans the step takes
over 25 minutes.

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


def _op_table(fn, acts, top=10):
    """Host-clock wall ms of one more run of ``fn`` (ending in a
    synchronize) and the self device ms of its largest ``aten``
    operators, as a share of that wall."""
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if e.key.startswith("aten::") and dev > 0:
            rows.append((e.key, dev))
    rows.sort(key=lambda kv: -kv[1])
    return {
        "wall_ms": wall / 1e3,
        "ops": [{"name": k, "device_ms": v / 1e3, "share_of_wall": v / wall}
                for k, v in rows[:top]],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--trace",
        default=os.path.join(ROOT, "gpyreg_tpu_torch", "build",
                             "profile_torch_slice.json"),
        help="where to write the Chrome trace",
    )
    parser.add_argument(
        "--group", choices=("all", "exact", "matrix_free"), default="all",
        help="the exact-path spans, the matrix-free and output-warping "
             "spans, or both",
    )
    parser.add_argument(
        "--spans", default="cg_fit,cg_predict,outwarp_fit",
        help="the matrix_free group's spans to run, comma-separated",
    )
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice.py needs a CUDA device")
    sys.path.insert(0, ROOT)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    out = {"card": smi}
    if args.group in ("all", "exact"):
        out.update(_profile_exact(args, acts))
    if args.group in ("all", "matrix_free"):
        out["matrix_free"] = _profile_matrix_free(args, acts)
    print(json.dumps(out))


def _report(spans, host, name):
    r = spans[name]
    print(f"{name}: wall {r['wall_ms']:.1f} ms (host clock "
          f"{host[name]:.1f} ms), device busy {r['device_busy_ms']:.1f} "
          f"ms, idle share {r['device_idle_share']:.4f}; without the "
          f"profiler wall {r['unprofiled_wall_ms']:.1f} ms (runs "
          f"{', '.join(f'{w:.1f}' for w in r['unprofiled_walls_ms'])}), "
          f"idle share {r['device_idle_share_unprofiled']:.4f}")
    for k in r["top_kernels"]:
        print(f"  {k['ms']:10.2f} ms {100 * k['share_of_wall']:6.2f}%  "
              f"{k['name']}")


def _profile_matrix_free(args, acts):
    """The matrix-free tier's and output warping's spans (module
    docstring, step 6)."""
    import numpy as np

    import gpyreg_tpu_torch as gt
    from chip_smoke import (CG_OPTS, D, D_CG, M_CG, N, OW_MAP, SEED,
                            _cg_data, _ow_data, _se_gp)

    X, y, xs, Xb, yb, _ = _cg_data()
    hyp0 = np.concatenate([np.full(D_CG, 0.5), [0.0], [-1.0], [0.0]])
    Xo, yo = _ow_data(N, D, 0, SEED + 8)[:2]

    def cg_fit(Xf=X, yf=y):
        g = _se_gp(D_CG, np.float32)
        np.random.seed(SEED)
        g.fit(Xf, yf, hyp0=hyp0, options={**CG_OPTS, "method": "cg"})
        return g

    def outwarp_fit():
        g = _se_gp(D, np.float32,
                   outwarp=gt.outwarp_functions.NegativePowerC1())
        np.random.seed(SEED)
        g.fit(Xo, yo, options=dict(OW_MAP))

    wanted = set(args.spans.split(","))
    fns = []
    if wanted & {"cg_fit", "cg_predict"}:
        # Warm-up at part B's size, then the full-width fit whose
        # posterior the predict span serves (its weights dropped before
        # every run).
        cg_fit(Xb, yb)
        gp = cg_fit()
        print(f"cg_fit_{X.shape[0]}: timings {gp.fit_timings}", flush=True)

        def cg_predict():
            for p in gp.posteriors:
                p._alpha = None
            gp.predict(xs)

        if "cg_fit" in wanted:
            fns.append((f"cg_fit_{X.shape[0]}", cg_fit))
        if "cg_predict" in wanted:
            fns.append((f"cg_predict_{M_CG}", cg_predict))
    if "outwarp_fit" in wanted:
        outwarp_fit()
        fns.append((f"outwarp_fit_{N}", outwarp_fit))
    host, spans, ops = {}, {}, {}
    for name, fn in fns:
        trace = f"{args.trace}.{name}.json"
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                fn()
                torch.cuda.synchronize()
            host[name] = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(trace)
        del prof
        spans.update(_spans(trace, (name,)))
        os.remove(trace)
        # One unprofiled run for the CG fit (a minute or more each),
        # three for the others.
        walls = []
        for _ in range(1 if name.startswith("cg_fit") else 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        r = spans[name]
        r["host_wall_ms"] = host[name]
        r["unprofiled_wall_ms"] = sorted(walls)[len(walls) // 2]
        r["unprofiled_walls_ms"] = walls
        r["device_idle_share_unprofiled"] = (
            1.0 - r["device_busy_ms"] / r["unprofiled_wall_ms"])
        _report(spans, host, name)
        ops[name] = _op_table(fn, acts)
        print(f"{name} by operator: wall {ops[name]['wall_ms']:.1f} ms")
        for row in ops[name]["ops"]:
            print(f"  {row['device_ms']:10.2f} ms "
                  f"{100 * row['share_of_wall']:6.2f}%  {row['name']}",
                  flush=True)
    return {"spans": spans, "operators": ops}


def _profile_exact(args, acts):
    """The exact path's spans (module docstring, steps 1-5)."""
    import numpy as np

    from gpyreg_tpu_torch import gp as gp_mod
    from chip_smoke import (D, D_TR, FIT_BENCH, FIT_HMC_BENCH, FIT_MALA_BENCH,
                            FIT_SAMPLE_BENCH, M_PF, M_QUAD, M_TEST, N, N_TR,
                            SEED, _data, _fit_data, _new_rows, _se_gp,
                            _train_data)
    from gpyreg_tpu_torch.inference import sampling

    X, y, xs, hyp = _data(N, M_TEST, SEED)
    gp = _se_gp(D, np.float32)
    gp.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=True)
    gp.predict(xs)
    X_tr, y_tr, hyps_tr = _train_data(N_TR, SEED)
    gp_tr = _se_gp(D_TR, np.float32)
    gp_tr.update(X_new=X_tr, y_new=y_tr, hyp=hyps_tr, compute_posterior=False)

    def nlml_grad(g, h):
        fns, args = g._obj_args()
        return fns["nlz_grad"](h, *args)

    # The rest of serving on a GP of its own: each rank-1 update adds a
    # row, which must not change the shapes of the spans above.
    gp_r = _se_gp(D, np.float32)
    gp_r.update(X_new=X, y_new=y, hyp=hyp, compute_posterior=True)
    rows = zip(*_new_rows(16, SEED + 11))

    def rank1():
        x_new, y_new = next(rows)
        gp_r.update(X_new=x_new[None, :], y_new=y_new[None, :])

    x_pf = xs[:M_PF]
    serve_fns = (
        ("rank1_update", rank1),
        ("predict_full_1024", lambda: gp_r.predict_full(x_pf)),
        ("quad_64", lambda: gp_r.quad(xs[:M_QUAD], 0.5, compute_var=True,
                                      separate_samples=True)),
        ("random_function_1024", lambda: gp_r.random_function(x_pf)),
        ("fmin", lambda: gp_r.fmin()),
    )
    for _, fn in serve_fns:
        fn()

    fit_n, fit_d, fit_options = FIT_BENCH
    fit_X, fit_y = _fit_data(fit_n, fit_d, SEED + 3)

    def fit(options=fit_options):
        g = _se_gp(fit_d, np.float32)
        np.random.seed(SEED)
        g.fit(fit_X, fit_y, options=dict(options))
        return g

    # The sampled fits take fit_bench's data; each one's chain gets a span
    # of its own (record_function costs nothing while no profiler runs).
    sampled = {}
    for spec, prefix in ((FIT_SAMPLE_BENCH, "fit_sample"),
                         (FIT_MALA_BENCH, "fit_mala"),
                         (FIT_HMC_BENCH, "fit_hmc")):
        _, samp_n, samp_d, samp_options = spec
        if (samp_n, samp_d) != (fit_n, fit_d):
            raise SystemExit(f"{spec[0]} and fit_bench differ in size")
        sampled[f"{prefix}_{samp_n}"] = samp_options
    run_sampling = sampling.run_sampling
    chain_of = []  # the span of the fit that runs

    def chain_span(*args, **kw):
        with torch.profiler.record_function(chain_of[-1] + "_chain"):
            out = run_sampling(*args, **kw)
            torch.cuda.synchronize()
        return out

    sampling.run_sampling = chain_span
    sample_s = {name: [] for name in sampled}

    def fit_sample(name):
        def run():
            chain_of.append(name)
            g = fit(sampled[name])
            sample_s[name].append(g.fit_timings["sample_s"] * 1e3)
            return g
        return run

    nlml_grad(gp, hyp)
    nlml_grad(gp_tr, hyps_tr)
    g = fit()
    print(f"fit_{fit_n}: timings {g.fit_timings}, restarts "
          f"{g.fit_report['restarts']}", flush=True)
    del g
    torch.cuda.synchronize()

    span_fns = (
        ("update", lambda: gp.update(hyp=hyp, compute_posterior=True)),
        ("predict", lambda: gp.predict(xs)),
        ("nlml_grad_16384", lambda: nlml_grad(gp, hyp)),
        ("nlml_grad_4096", lambda: nlml_grad(gp_tr, hyps_tr)),
    ) + serve_fns
    fit_spans = ((f"fit_{fit_n}", fit),) + tuple(
        (name, fit_sample(name)) for name in sampled)
    host, spans = {}, {}
    runs = [(args.trace, span_fns, ())] + [
        (f"{args.trace}.{name}.json", ((name, fn),),
         (name + "_chain",) if name in sampled else ())
        for name, fn in fit_spans
    ]
    for trace, fns, inner in runs:
        with torch.profiler.profile(activities=acts) as prof:
            for name, fn in fns:
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    fn()
                    torch.cuda.synchronize()
                host[name] = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(trace)
        del prof
        spans.update(_spans(trace, tuple(name for name, _ in fns) + inner))
        if trace != args.trace:
            os.remove(trace)
    for name in sampled:
        host[name + "_chain"] = sample_s[name].pop()
    for name, fn in span_fns + fit_spans:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if name in sampled:
            r = spans[name + "_chain"]
            r["host_wall_ms"] = host[name + "_chain"]
            r["unprofiled_wall_ms"] = sorted(sample_s[name])[1]
            r["unprofiled_walls_ms"] = list(sample_s[name])
            r["device_idle_share_unprofiled"] = (
                1.0 - r["device_busy_ms"] / r["unprofiled_wall_ms"]
            )
        r = spans[name]
        r["host_wall_ms"] = host[name]
        r["unprofiled_wall_ms"] = sorted(walls)[1]
        r["unprofiled_walls_ms"] = walls
        r["device_idle_share_unprofiled"] = (
            1.0 - r["device_busy_ms"] / r["unprofiled_wall_ms"]
        )
    for name in spans:
        _report(spans, host, name)

    ops = {}
    for name, fn in (("nlml_grad_16384", lambda: nlml_grad(gp, hyp)),
                     ("nlml_grad_4096", lambda: nlml_grad(gp_tr, hyps_tr)),
                     *(f for f in serve_fns
                       if f[0] in ("rank1_update", "predict_full_1024",
                                   "fmin")),
                     *fit_spans):
        ops[name] = _op_table(fn, acts)
        print(f"{name} by operator: wall {ops[name]['wall_ms']:.1f} ms")
        for r in ops[name]["ops"]:
            print(f"  {r['device_ms']:10.2f} ms {100 * r['share_of_wall']:6.2f}%"
                  f"  {r['name']}")

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
    return {"spans": spans, "operators": ops, "chunk_sweep": sweep}


if __name__ == "__main__":
    main()
